"""Inverted index reader + BM25 search.

Reference behavior (reference: inverted_index_reader.rs:108-300 +
type_check/search.rs): ``match(col, 'q', 'fuzziness=1;operator=AND')``
scores with BM25 (k1=1.2, b=0.75, Lucene idf), ``query('col:a AND b')``
supports boolean syntax, quoted phrases match on stored positions
(reference inverted_index_reader.rs:154-239). Scoring is a segmented
sparse accumulation over the CSR postings — on device (one segment-sum
program, device.py) for blocks above DEVICE_MIN_DOCS, numpy below that.
"""

from __future__ import annotations

import bisect
import io
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .tokenizer import tokenize_text

K1 = 1.2
B = 0.75


# blocks at least this large get a cached DeviceBM25 for the top-k
# serving path (full-score materialization stays on host numpy: shipping
# a [n_docs] score vector off-device costs more than scoring it); the
# served path's gate, service/prepared.py _MatchServer.DEVICE_MIN_DOCS,
# measured on the card (NVIDIA H100 80GB HBM3, 700.00 W)
DEVICE_MIN_DOCS = 2_000


@dataclass
class InvertedBlockReader:
    terms: List[str]
    offsets: np.ndarray
    doc_ids: np.ndarray
    tfs: np.ndarray
    doc_len: np.ndarray
    n_docs: int
    tokenizer: str
    filters: List[str]
    # second-level CSR of within-doc token positions (phrase queries);
    # None for indexes written before positions were stored
    pos_offsets: "Optional[np.ndarray]" = None
    positions: "Optional[np.ndarray]" = None

    @property
    def nbytes(self) -> int:
        return self.doc_ids.nbytes + self.tfs.nbytes + self.doc_len.nbytes

    @staticmethod
    def load(path: str) -> "InvertedBlockReader":
        from ...storage.operator import OPERATOR
        z = np.load(OPERATOR.open_read(path))
        terms = z["terms"].tobytes().decode("utf-8")
        terms = terms.split("\n") if terms else []
        filters = z["filters"].tobytes().decode()
        return InvertedBlockReader(
            terms, z["offsets"], z["doc_ids"], z["tfs"], z["doc_len"],
            int(z["meta"][0]), z["tokenizer"].tobytes().decode(),
            [f for f in filters.split(",") if f],
            z["pos_offsets"] if "pos_offsets" in z else None,
            z["positions"] if "positions" in z else None)

    # ------------------------------------------------------------------ terms
    def term_id(self, term: str) -> int:
        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def fuzzy_term_ids(self, term: str, fuzziness: int) -> List[int]:
        """Terms within the given edit distance (reference supports
        fuzziness<=2 via tantivy's Levenshtein automata)."""
        out = []
        for i, t in enumerate(self.terms):
            if abs(len(t) - len(term)) > fuzziness:
                continue
            if _edit_distance_leq(term, t, fuzziness):
                out.append(i)
        return out

    def postings(self, tid: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
        return self.doc_ids[s:e], self.tfs[s:e]

    # ----------------------------------------------------------------- search
    def bm25_scores(self, term_groups: List[List[int]], operator: str = "OR"):
        """BM25 over groups of term ids (a group = one query token and its
        fuzzy expansions). AND requires every group to match.
        Returns (rows, scores)."""
        if not term_groups:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        avgdl = float(self.doc_len.mean()) if self.n_docs else 1.0
        scores = np.zeros(self.n_docs, np.float64)
        matched_groups = np.zeros(self.n_docs, np.int32)
        n_present = 0
        for group in term_groups:
            group = [t for t in group if t >= 0]
            if not group:
                continue
            n_present += 1
            group_hit = np.zeros(self.n_docs, bool)
            for tid in group:
                docs, tfs = self.postings(tid)
                df = len(docs)
                idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
                dl = self.doc_len[docs]
                denom = tfs + K1 * (1 - B + B * dl / max(avgdl, 1e-9))
                scores[docs] += idf * (tfs * (K1 + 1)) / np.maximum(denom, 1e-9)
                group_hit[docs] = True
            matched_groups += group_hit
        if operator.upper() == "AND":
            need = len([g for g in term_groups if any(t >= 0 for t in g)])
            if need < len(term_groups):
                return np.zeros(0, np.int64), np.zeros(0, np.float32)  # missing term
            hit = matched_groups >= need
        else:
            hit = matched_groups > 0
        rows = np.nonzero(hit)[0]
        return rows, scores[rows].astype(np.float32)

    def _device_bm25(self):
        dev = getattr(self, "_dev_scorer", None)
        if dev is None:
            from .device import DeviceBM25
            dev = DeviceBM25(self)
            self._dev_scorer = dev
        return dev

    # ---------------------------------------------------------------- phrase
    def term_positions(self, tid: int) -> List[np.ndarray]:
        """Per posting entry of term tid: the within-doc positions."""
        if self.pos_offsets is None:
            from ...errors import UnsupportedFeature
            raise UnsupportedFeature(
                "phrase queries need positions; REFRESH the inverted index")
        s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
        return [self.positions[int(self.pos_offsets[j]):
                               int(self.pos_offsets[j + 1])]
                for j in range(s, e)]

    def phrase_match(self, tokens: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Docs containing the tokens at consecutive positions (reference
        phrase query, inverted_index_reader.rs:154-239). Scores = BM25 of
        the constituent terms on matching docs."""
        tids = [self.term_id(t) for t in tokens]
        if any(t < 0 for t in tids):
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        # start from the first term's candidate positions per doc
        docs0, _ = self.postings(tids[0])
        cand = {int(d): p for d, p in zip(docs0, self.term_positions(tids[0]))}
        for k, tid in enumerate(tids[1:], start=1):
            docs_k, _ = self.postings(tid)
            pos_k = self.term_positions(tid)
            pk = {int(d): p for d, p in zip(docs_k, pos_k)}
            nxt = {}
            for d, starts in cand.items():
                p = pk.get(d)
                if p is None:
                    continue
                # keep phrase starts whose k-th token sits at start+k
                keep = starts[np.isin(starts + k, p)]
                if len(keep):
                    nxt[d] = keep
            cand = nxt
            if not cand:
                break
        rows = np.array(sorted(cand), np.int64)
        if not len(rows):
            return rows, np.zeros(0, np.float32)
        all_rows, all_scores = self.bm25_scores([[t] for t in tids], "AND")
        smap = dict(zip(all_rows.tolist(), all_scores.tolist()))
        return rows, np.array([smap.get(int(r), 0.0) for r in rows],
                              np.float32)


def _edit_distance_leq(a: str, b: str, k: int) -> bool:
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        lo = lb + 1
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
            lo = min(lo, cur[j])
        if lo > k:
            return False
        prev = cur
    return prev[lb] <= k


def search_block(reader: InvertedBlockReader, info) -> Tuple[list, Optional[list]]:
    """Run a match()/query() search against one block's index.
    Returns (rows, scores)."""
    if info.is_match:
        qt = info.query_text.strip()
        if len(qt) >= 2 and qt.startswith('"') and qt.endswith('"'):
            # quoted phrase: positions-based consecutive match
            tokens = tokenize_text(qt[1:-1], reader.tokenizer, reader.filters)
            rows, scores = reader.phrase_match(tokens)
            return rows.tolist(), scores.tolist()
        tokens = tokenize_text(qt, reader.tokenizer, reader.filters)
        groups = []
        for tok in tokens:
            if info.fuzziness:
                groups.append(reader.fuzzy_term_ids(tok, int(info.fuzziness)))
            else:
                groups.append([reader.term_id(tok)])
        rows, scores = reader.bm25_scores(groups, info.operator)
    else:
        rows, scores = _eval_query_syntax(reader, info.query_text,
                                          int(getattr(info, "fuzziness", 0)
                                              or 0))
    return rows.tolist(), scores.tolist()


def _eval_query_syntax(reader: InvertedBlockReader, q: str,
                       fuzziness: int = 0):
    """Tantivy-style boolean query syntax (reference query() pushdown):
    `a AND b`, `col:a OR b`, NOT, quoted phrases, `+must` / `-must_not`
    prefixes, parenthesized groups `col:(a b)`, `term^boost` (boost
    accepted; scores are this engine's BM25, not tantivy's). Field
    prefixes select no subset (per-block postings span all indexed
    columns) but are parsed."""
    import re as _re
    # parens group terms under one field prefix; flatten by distributing
    # the prefix (field choice doesn't change candidate sets here)
    q = _re.sub(r'(\w+):\(([^)]*)\)', lambda m: m.group(2), q)
    q = q.replace("(", " ").replace(")", " ")
    q = _re.sub(r'\^[0-9.]+', "", q)  # strip boosts
    tokens = _re.findall(r'[+\-]?[\w.]+:"[^"]*"|[+\-]?"[^"]*"|\S+', q)

    def eval_term(raw: str):
        body = raw.split(":", 1)[-1]
        is_phrase = body.startswith('"') and body.endswith('"') \
            and len(body) >= 2
        term = body.strip('"').lower()
        toks = tokenize_text(term, reader.tokenizer, reader.filters)
        if is_phrase and len(toks) > 1:
            return reader.phrase_match(toks)
        if fuzziness:
            groups = [reader.fuzzy_term_ids(t, fuzziness) for t in toks]
        else:
            groups = [[reader.term_id(t)] for t in toks]
        return reader.bm25_scores(groups, "AND")

    # tantivy occur semantics when +/- prefixes are present
    if any(t[0] in "+-" and len(t) > 1 for t in tokens):
        musts, shoulds, must_nots = [], [], []
        for raw in tokens:
            if raw.upper() in ("AND", "OR", "NOT"):
                continue
            if raw.startswith("+"):
                musts.append(eval_term(raw[1:]))
            elif raw.startswith("-"):
                must_nots.append(eval_term(raw[1:]))
            else:
                shoulds.append(eval_term(raw))
        if musts:
            cand = musts[0][0]
            for rows, _ in musts[1:]:
                cand = np.intersect1d(cand, rows)
        else:
            cand = np.unique(np.concatenate(
                [r for r, _ in shoulds])) if shoulds \
                else np.zeros(0, np.int64)
        for rows, _ in must_nots:
            cand = np.setdiff1d(cand, rows)
        score_map = {int(r): 0.0 for r in cand.tolist()}
        for rows, scores in musts + shoulds:
            for r, s in zip(rows.tolist(), scores.tolist()):
                if r in score_map:
                    score_map[r] += s
        out_rows = np.array(sorted(score_map), np.int64)
        out_scores = np.array([score_map[int(r)] for r in out_rows],
                              np.float32)
        return out_rows, out_scores

    # shunting-less left-fold: term [op term]*
    result_rows: Optional[np.ndarray] = None
    result_scores: Optional[np.ndarray] = None
    pending_op = "OR"
    negate_next = False
    for raw in tokens:
        up = raw.upper()
        if up in ("AND", "OR"):
            pending_op = up
            continue
        if up == "NOT":
            negate_next = True
            continue
        rows, scores = eval_term(raw)
        if negate_next:
            all_rows = np.arange(reader.n_docs)
            mask = np.ones(reader.n_docs, bool)
            mask[rows] = False
            rows = all_rows[mask]
            scores = np.zeros(len(rows), np.float32)
            negate_next = False
        if result_rows is None:
            result_rows, result_scores = rows, scores
        elif pending_op == "AND":
            common, ia, ib = np.intersect1d(result_rows, rows, return_indices=True)
            result_rows = common
            result_scores = result_scores[ia] + scores[ib]
        else:
            merged = {}
            for r, s in zip(result_rows.tolist(), result_scores.tolist()):
                merged[r] = merged.get(r, 0.0) + s
            for r, s in zip(rows.tolist(), scores.tolist()):
                merged[r] = merged.get(r, 0.0) + s
            result_rows = np.array(sorted(merged), np.int64)
            result_scores = np.array([merged[r] for r in sorted(merged)], np.float32)
    if result_rows is None:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    return result_rows, result_scores
