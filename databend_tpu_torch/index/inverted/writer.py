"""Inverted (BM25) index writer: per-block CSR postings + positions.

The reference embeds a single-segment tantivy index per block
(reference: inverted_index_writer.rs:189-273) with term positions stored
for phrase queries (inverted_index_reader.rs:154-239). Here the per-block
index is flat CSR arrays — term dictionary, postings offsets, doc ids,
term frequencies, doc lengths, and a second-level CSR of within-doc token
positions — the layout a segmented-sparse BM25 kernel consumes directly
(device or host).
"""

from __future__ import annotations

import io
from typing import Dict, List

import numpy as np

from .tokenizer import parse_filters, tokenize_docs


def build_inverted_index(path: str, columns, options: Dict[str, str]) -> int:
    """Build and save one block's inverted index over text columns.
    Documents are the row-wise concatenation of the indexed columns
    (per-column fields share one posting space like the reference's
    multi-field schema). Returns file size.

    Fast path: the native C++ analyzer (native/tokenize.cpp) tokenizes and
    dedups the vocabulary in one pass; postings/positions are then pure
    numpy over (term_id, doc_id) arrays — the ingest analog of the
    reference's native tantivy segment build."""
    tokenizer = options.get("tokenizer", "english")
    filters = parse_filters(options)
    n_docs = len(columns[0]) if columns else 0
    col_lists = [c.to_pylist() for c in columns]

    native_out = _analyze_native(col_lists, n_docs, filters)
    if native_out is not None:
        (terms, offsets, doc_ids, tfs, doc_len, pos_offsets,
         positions_arr) = native_out
    else:
        (terms, offsets, doc_ids, tfs, doc_len, pos_offsets,
         positions_arr) = _build_python(col_lists, n_docs, tokenizer, filters)

    data = _serialize(path, terms, offsets, doc_ids, tfs, doc_len,
                      pos_offsets, positions_arr, n_docs, tokenizer, filters)
    return data


def _analyze_native(col_lists, n_docs: int, filters):
    """Native one-pass analysis + vectorized CSR build; None = fall back."""
    from ... import native
    from .tokenizer import ENGLISH_STOPWORDS, _get_stemmer
    stop = ENGLISH_STOPWORDS if ("english_stop" in filters
                                 or "chinese_stop" in filters) else None
    # per-doc concatenation of columns ('\n' is a token separator, so the
    # token sequence matches sequential per-column tokenization)
    docs = ["\n".join("" if col[d] is None else str(col[d])
                      for col in col_lists) for d in range(n_docs)]
    res = native.analyze_batch(docs, stop)
    if res is None:
        return None
    terms, tok_term, tok_doc = res
    if "english_stemmer" in filters and terms:
        stem = _get_stemmer().stem
        first: Dict[str, int] = {}
        remap = np.empty(len(terms), np.int32)
        new_terms: List[str] = []
        for i, t in enumerate(terms):
            st = stem(t)
            j = first.get(st)
            if j is None:
                first[st] = j = len(new_terms)
                new_terms.append(st)
            remap[i] = j
        terms = new_terms
        tok_term = remap[tok_term]
    # lexicographic term order for binary search
    sort_idx = sorted(range(len(terms)), key=lambda i: terms[i])
    rank = np.empty(max(len(terms), 1), np.int32)
    rank[np.asarray(sort_idx, np.int64)] = np.arange(len(terms), dtype=np.int32)
    terms = [terms[i] for i in sort_idx]
    n_tok = len(tok_doc)
    doc_len = np.bincount(tok_doc, minlength=n_docs).astype(np.int32) \
        if n_tok else np.zeros(n_docs, np.int32)
    if n_tok == 0:
        return (terms, np.zeros(len(terms) + 1, np.int64),
                np.zeros(0, np.int32), np.zeros(0, np.int32), doc_len,
                np.zeros(1, np.int64), np.zeros(0, np.int32))
    tok_term = rank[tok_term]
    # within-doc positions: tok_doc is nondecreasing by construction
    doc_starts = np.zeros(n_docs + 1, np.int64)
    np.cumsum(doc_len, out=doc_starts[1:])
    pos_in_doc = (np.arange(n_tok, dtype=np.int64)
                  - doc_starts[tok_doc]).astype(np.int32)
    # stable (term, doc) grouping keeps positions ascending per group
    order = np.lexsort((tok_doc, tok_term))
    st_, sd_, sp_ = tok_term[order], tok_doc[order], pos_in_doc[order]
    change = np.ones(n_tok, bool)
    change[1:] = (st_[1:] != st_[:-1]) | (sd_[1:] != sd_[:-1])
    group_start = np.flatnonzero(change)
    tfs = np.diff(np.append(group_start, n_tok)).astype(np.int32)
    doc_ids = sd_[group_start].astype(np.int32)
    offsets = np.zeros(len(terms) + 1, np.int64)
    np.cumsum(np.bincount(st_[group_start], minlength=len(terms)),
              out=offsets[1:])
    pos_offsets = np.zeros(len(tfs) + 1, np.int64)
    np.cumsum(tfs, out=pos_offsets[1:])
    return terms, offsets, doc_ids, tfs, doc_len, pos_offsets, sp_.astype(np.int32)


def _build_python(col_lists, n_docs: int, tokenizer: str, filters):
    """Pure-Python reference path (also the no-toolchain fallback)."""
    vocab: Dict[str, int] = {}
    term_docs: List[List[int]] = []
    term_tfs: List[List[int]] = []
    term_pos: List[List[List[int]]] = []
    doc_len = np.zeros(n_docs, np.int32)
    col_tokens = [tokenize_docs(["" if v is None else str(v) for v in col],
                                tokenizer, filters) for col in col_lists]
    for doc_id in range(n_docs):
        counts: Dict[str, int] = {}
        positions: Dict[str, List[int]] = {}
        total = 0
        for toks in col_tokens:
            for tok in toks[doc_id]:
                counts[tok] = counts.get(tok, 0) + 1
                positions.setdefault(tok, []).append(total)
                total += 1
        doc_len[doc_id] = total
        for tok, tf in counts.items():
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
                term_docs.append([])
                term_tfs.append([])
                term_pos.append([])
            term_docs[tid].append(doc_id)
            term_tfs[tid].append(tf)
            term_pos[tid].append(positions[tok])

    terms = sorted(vocab)
    order = [vocab[t] for t in terms]
    offsets = np.zeros(len(terms) + 1, np.int64)
    for i, tid in enumerate(order):
        offsets[i + 1] = offsets[i] + len(term_docs[tid])
    nnz = int(offsets[-1])
    doc_ids = np.zeros(nnz, np.int32)
    tfs = np.zeros(nnz, np.int32)
    pos_counts = np.zeros(nnz, np.int64)
    flat_pos: List[int] = []
    j = 0
    for i, tid in enumerate(order):
        doc_ids[offsets[i]: offsets[i + 1]] = term_docs[tid]
        tfs[offsets[i]: offsets[i + 1]] = term_tfs[tid]
        for plist in term_pos[tid]:
            pos_counts[j] = len(plist)
            flat_pos.extend(plist)
            j += 1
    pos_offsets = np.zeros(nnz + 1, np.int64)
    np.cumsum(pos_counts, out=pos_offsets[1:])
    positions_arr = np.asarray(flat_pos, np.int32)
    return terms, offsets, doc_ids, tfs, doc_len, pos_offsets, positions_arr


def _serialize(path, terms, offsets, doc_ids, tfs, doc_len, pos_offsets,
               positions_arr, n_docs, tokenizer, filters) -> int:
    term_blob = "\n".join(terms).encode("utf-8")
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        terms=np.frombuffer(term_blob, np.uint8),
        offsets=offsets, doc_ids=doc_ids, tfs=tfs, doc_len=doc_len,
        pos_offsets=pos_offsets, positions=positions_arr,
        meta=np.array([n_docs], np.int64),
        tokenizer=np.frombuffer(tokenizer.encode(), np.uint8),
        filters=np.frombuffer(",".join(filters).encode(), np.uint8))
    data = buf.getvalue()
    from ...storage.operator import OPERATOR
    OPERATOR.write_bytes(path, data)
    return len(data)
