"""Device BM25: postings resident on the card, queries ship scalars (port of
``databend_tpu/index/inverted/device.py``).

The reference scores BM25 inside tantivy on the host
(inverted_index_reader.rs:108-150). The device path keeps a block's postings
on the card, uploaded once per block like the vector columns, in two layouts:

* ``DeviceBM25``: the CSR postings (doc ids, term frequencies, doc lengths).
  A query ships per-term scalars (posting start and length, idf, group id);
  the programs gather the terms' posting slices, compute the BM25
  contributions and reduce them per doc: ``_bm25_program`` with
  ``index_add_`` into the dense score vector, the top-k programs by sorting
  the (doc, group, contribution) triples and reducing runs with a segmented
  Hillis-Steele scan. Shapes are bucketed as in the reference (term count and
  posting length), which bounds the padding work.
* ``ImpactBM25``: the dense doc-major layout for batched serving. Scoring
  and the top-k per query are one hand-written kernel,
  ``ops.impact_bm25.impact_bm25_topk`` (its plain version on CPU tensors):
  the ``[b, n_pad]`` score block is never written.

The reference's jitted programs are plain functions on tensors here. Equal
scores rank by ascending row id, inside the top k and at its boundary, as
``jax.lax.top_k`` ranks them (``ops.topk.topk_largest_lowest_index``).
Results leave the device as one (values, rows) pair per ``collect``; nothing
between two dispatches waits for the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ... import backend
from ...ops.impact_bm25 import impact_bm25_topk, pack_query_terms
from ...ops.topk import topk_largest_lowest_index

K1 = 1.2
B = 0.75


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _upload(*arrays: np.ndarray) -> List[torch.Tensor]:
    """Small host arrays of 4-byte elements -> device tensors of the same
    shapes and types through ONE host->device copy (a query's operands)."""
    flat = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32)
                           for a in arrays])
    buf = backend.to_device(flat)
    out, off = [], 0
    for a in arrays:
        t = buf[off:off + a.size]
        if a.dtype == np.float32:
            t = t.view(torch.float32)
        out.append(t.reshape(a.shape))
        off += a.size
    return out


def _fetch_pair(vals: torch.Tensor, rows: torch.Tensor):
    """One device->host copy of a (values, rows) pair."""
    vals, rows = backend.to_numpy([vals, rows.to(torch.int32)])
    return vals, rows


def _shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` moved ``shift`` places to the right, zeros shifted in."""
    out = torch.zeros_like(x)
    out[shift:] = x[:-shift]
    return out


def _posting_terms(doc_ids_full, tfs_full, doc_len, starts, lens, idf, live,
                   avgdl, l: int):
    """Gather each term's posting slice ``[T, L]`` and its BM25 terms; slots
    past a posting's length, and terms with ``live`` false, are invalid."""
    ar = torch.arange(l, dtype=torch.int32, device=starts.device)[None, :]
    pos = starts[:, None] + ar
    valid = (ar < lens[:, None]) & live[:, None]
    safe_pos = pos.clamp(0, doc_ids_full.shape[0] - 1)
    doc_ids = doc_ids_full[safe_pos]
    tfs = tfs_full[safe_pos]
    dl = doc_len[doc_ids]
    denom = tfs + K1 * (1.0 - B + B * dl / avgdl)
    elem = torch.where(valid,
                       idf[:, None] * tfs * (K1 + 1.0)
                       / torch.clamp_min(denom, 1e-9), 0.0)
    return doc_ids, valid, elem


def _bm25_program(doc_ids_full, tfs_full, doc_len, starts, lens, idf, gid,
                  avgdl: float, l: int, g: int, n_docs: int):
    """Dense per-doc scores and per-doc count of matched groups. The two
    ``segment_sum``s of the reference are ``index_add_``s: atomic adds on the
    card, so the f32 sum order is not fixed from run to run. Held to the
    reference's own tolerance (rtol 1e-4, tests/test_bm25_device.py)."""
    doc_ids, valid, elem = _posting_terms(
        doc_ids_full, tfs_full, doc_len, starts, lens, idf, gid >= 0, avgdl, l)
    flat_ids = torch.where(valid, doc_ids, n_docs)          # pad bucket
    scores = torch.zeros(n_docs + 1, dtype=torch.float32, device=elem.device)
    scores.index_add_(0, flat_ids.reshape(-1), elem.reshape(-1))
    # per-group distinct-match count (AND semantics)
    safe_gid = torch.where(gid >= 0, gid, 0).to(torch.int64)
    cid = safe_gid[:, None] * (n_docs + 1) + flat_ids        # [T, L]
    ghit = torch.zeros(g * (n_docs + 1), dtype=torch.float32,
                       device=elem.device)
    ghit.index_add_(0, cid.reshape(-1), valid.reshape(-1).to(torch.float32))
    matched = (ghit.reshape(g, n_docs + 1)[:, :n_docs] > 0).sum(0)
    return scores[:n_docs], matched.to(torch.int32)


def _reduce_runs(key_s, same_doc_of, el_s, t: int):
    """Run-local inclusive sums of the sorted contributions ``el_s`` and of
    the (doc, group) boundary flags, by a segmented Hillis-Steele scan: runs
    of one doc are contiguous and at most ``t`` long after the sort.
    ``same_doc_of(shift)`` says which entries share their doc with the entry
    ``shift`` places before them. -> (total, distinct groups) per entry."""
    cnt = torch.ones_like(el_s)
    cnt[1:] = (key_s[1:] != key_s[:-1]).to(el_s.dtype)
    total = el_s
    shift = 1
    while shift < t:
        same = same_doc_of(shift)
        total = total + torch.where(same, _shift(total, shift), 0.0)
        cnt = cnt + torch.where(same, _shift(cnt, shift), 0.0)
        shift <<= 1
    return total, cnt


def _same_as_before(ids_s: torch.Tensor, shift: int) -> torch.Tensor:
    same = torch.zeros_like(ids_s, dtype=torch.bool)
    same[shift:] = ids_s[shift:] == ids_s[:-shift]
    return same


def _run_ends(ids_s: torch.Tensor) -> torch.Tensor:
    is_end = torch.ones_like(ids_s, dtype=torch.bool)
    is_end[:-1] = ids_s[1:] != ids_s[:-1]
    return is_end


def _bm25_topk_program(doc_ids_full, tfs_full, doc_len, starts, lens, idf,
                       gid, avgdl: float, need: int, t: int, l: int, g: int,
                       n_docs: int, k: int):
    """Scatter-free top-k BM25: sort the (doc, group, contribution) triples
    (each doc appears at most once per query term, so runs are <= T long),
    reduce runs with ``_reduce_runs``, top-k over the run ends. torch has no
    lexicographic sort of several operands: the two keys become one int64,
    ``doc * (g + 1) + group + 1``, under a stable sort."""
    doc_ids, valid, elem = _posting_terms(
        doc_ids_full, tfs_full, doc_len, starts, lens, idf, gid >= 0, avgdl, l)
    ids = torch.where(valid, doc_ids, n_docs).reshape(-1).to(torch.int64)
    gg = (gid[:, None] + 1).expand(t, l).reshape(-1)
    key_s, order = torch.sort(ids * (g + 1) + gg, stable=True)
    ids_s = ids[order]
    total, cnt = _reduce_runs(key_s, lambda s: _same_as_before(ids_s, s),
                              elem.reshape(-1)[order], t)
    ok = _run_ends(ids_s) & (ids_s < n_docs) & (cnt >= float(need))
    masked = torch.where(ok, total, -torch.inf)
    vals, sel = topk_largest_lowest_index(masked[None, :], k)
    return vals[0], ids_s[sel[0]]


def _bm25_batch_topk_program(doc_ids_full, tfs_full, doc_len, starts, lens,
                             idf, qid, qgid, need, avgdl: float, t: int,
                             l: int, n_docs: int, k: int, b: int,
                             n_groups: int):
    """B queries per ONE sort: term posting slices stack across the query
    batch, the sort key becomes (query * span + doc, group) folded into one
    int64 (``b * span * n_groups`` passes 2^31 at serving sizes), the run
    reduction is unchanged, and the unique (query, doc) run-end scores
    scatter into a dense ``[B, n_docs]`` for one batched top-k."""
    doc_ids, valid, elem = _posting_terms(
        doc_ids_full, tfs_full, doc_len, starts, lens, idf, qid >= 0, avgdl, l)
    span = n_docs + 1
    safe_qid = torch.where(qid >= 0, qid, b).to(torch.int64)
    comp = torch.where(valid, safe_qid[:, None] * span + doc_ids,
                       b * span).reshape(-1)
    gg = qgid[:, None].expand(t, l).reshape(-1)
    key_s, order = torch.sort(comp * n_groups + gg, stable=True)
    comp_s = comp[order]
    total, cnt = _reduce_runs(key_s, lambda s: _same_as_before(comp_s, s),
                              elem.reshape(-1)[order], t)
    q_of = comp_s // span
    need_of = torch.cat([need, need.new_ones(1)])[q_of.clamp(0, b)]
    ok = _run_ends(comp_s) & (comp_s < b * span) \
        & ((comp_s % span) < n_docs) & (cnt >= need_of)
    # run-end (query, doc) pairs are unique: a plain scatter; every entry
    # that is not one lands in the spare last cell as -inf
    dense = torch.full((b * span + 1,), -torch.inf, dtype=torch.float32,
                       device=elem.device)
    dense[torch.where(ok, comp_s, b * span)] = \
        torch.where(ok, total, -torch.inf)
    dense = dense[:b * span].reshape(b, span)[:, :n_docs]
    return topk_largest_lowest_index(dense, k)


class DeviceBM25:
    """Per-block device scorer; postings upload once, queries ship scalars."""

    def __init__(self, reader):
        self.reader = reader
        self.n_docs = reader.n_docs
        self.avgdl = float(reader.doc_len.mean()) if reader.n_docs else 1.0
        self._doc_ids = backend.to_device(reader.doc_ids.astype(np.int32))
        self._tfs = backend.to_device(reader.tfs.astype(np.float32))
        self._doc_len = backend.to_device(reader.doc_len.astype(np.float32))
        # coarse posting-length buckets (x16 steps): queries on rare terms
        # pay small sorts
        max_df = int((reader.offsets[1:] - reader.offsets[:-1]).max(initial=1))
        self._l_max = max_df

    def _avgdl(self) -> float:
        return float(np.float32(max(self.avgdl, 1e-9)))

    def _pack_terms(self, terms):
        """Per-term scalars of ``(term id, tag)`` pairs, padded to the bucket:
        -> (t_b, l_b, starts, lens, idf, tags); pad terms carry tag -1."""
        r = self.reader
        t_b = _bucket(len(terms))
        max_len = max(int(r.offsets[tid + 1] - r.offsets[tid])
                      for tid, _ in terms)
        l_b = 128
        while l_b < max_len:
            l_b <<= 4  # coarse x16 buckets
        l_b = min(l_b, _bucket(self._l_max, lo=128))
        starts = np.zeros(t_b, np.int32)
        lens = np.zeros(t_b, np.int32)
        idf = np.zeros(t_b, np.float32)
        tags = np.full(t_b, -1, np.int32)
        for i, (tid, tag) in enumerate(terms):
            s, e = int(r.offsets[tid]), int(r.offsets[tid + 1])
            starts[i], lens[i] = s, e - s
            df = e - s
            idf[i] = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
            tags[i] = tag
        return t_b, l_b, starts, lens, idf, tags

    def score_async(self, term_groups: List[List[int]], operator: str = "OR"):
        """Dispatch without syncing; returns a thunk resolving to
        (rows, scores). Lets callers queue many queries and sync once."""
        terms = [(tid, gi) for gi, group in enumerate(term_groups)
                 for tid in group if tid >= 0]
        n_present = len({gi for _, gi in terms})
        if not terms:
            empty = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            return lambda: empty
        t_b, l_b, starts, lens, idf, gid = self._pack_terms(terms)
        g_b = _bucket(len(term_groups), lo=4)
        scores_dev, matched_dev = _bm25_program(
            self._doc_ids, self._tfs, self._doc_len,
            *_upload(starts, lens, idf, gid), self._avgdl(), l_b, g_b,
            self.n_docs)

        def resolve():
            scores, matched = backend.to_numpy([scores_dev, matched_dev])
            if operator.upper() == "AND":
                if n_present < len(term_groups):
                    return (np.zeros(0, np.int64), np.zeros(0, np.float32))
                hit = matched >= n_present
            else:
                hit = matched > 0
            rows = np.nonzero(hit)[0]
            return rows, scores[rows].astype(np.float32)

        return resolve

    def score(self, term_groups: List[List[int]], operator: str = "OR"
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, scores) — same contract as the host bm25_scores."""
        return self.score_async(term_groups, operator)()

    def top_k(self, term_groups: List[List[int]], k: int,
              operator: str = "OR") -> Tuple[np.ndarray, np.ndarray]:
        """Serving path: top-k matching docs by BM25, selected ON DEVICE so
        only k (row, score) pairs leave the card (the match() + ORDER BY
        score() LIMIT k pushdown; the reference's tantivy TopDocs
        collector, inverted_index_reader.rs:123 order_by_score)."""
        terms = [(tid, gi) for gi, group in enumerate(term_groups)
                 for tid in group if tid >= 0]
        n_present = len({gi for _, gi in terms})
        if not terms or (operator.upper() == "AND"
                         and n_present < len(term_groups)):
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        vals, rows = _fetch_pair(*self._dispatch_topk(term_groups, k, operator))
        ok = vals > -np.inf
        return rows[ok].astype(np.int64), vals[ok].astype(np.float32)

    def top_k_batch(self, queries: List[List[List[int]]], k: int,
                    operator: str = "OR"
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Top-k for a BATCH of queries in one device program (one sort
        serves all of them). ``queries[b]`` is that query's term_groups.
        Returns [(rows, scores)] per query, same contract as top_k."""
        flat = []   # (term, query, global_group)
        need = []
        gbase = 0
        present = []
        for qi, tg in enumerate(queries):
            terms = [(tid, qi, gbase + gi) for gi, group in enumerate(tg)
                     for tid in group if tid >= 0]
            flat.extend(terms)
            n_present = len({g for _, _, g in terms})
            present.append(n_present)
            need.append(float(n_present) if operator.upper() == "AND"
                        else 1.0)
            gbase += len(tg)
        bq = len(queries)
        empty = (np.zeros(0, np.int64), np.zeros(0, np.float32))
        if not flat:
            return [empty] * bq
        t_b, l_b, starts, lens, idf, qid = self._pack_terms(
            [(tid, qi) for tid, qi, _ in flat])
        b_b = _bucket(bq, lo=2)
        qgid = np.zeros(t_b, np.int32)
        qgid[:len(flat)] = [gg for _, _, gg in flat]
        need_arr = np.ones(b_b, np.float32)
        need_arr[:bq] = need
        vals, ids = _fetch_pair(*_bm25_batch_topk_program(
            self._doc_ids, self._tfs, self._doc_len,
            *_upload(starts, lens, idf, qid, qgid, need_arr), self._avgdl(),
            t_b, l_b, self.n_docs, min(k, self.n_docs), b_b, max(gbase, 1)))
        out = []
        for qi, tg in enumerate(queries):
            if operator.upper() == "AND" and present[qi] < len(tg):
                out.append(empty)
                continue
            ok = vals[qi] > -np.inf
            out.append((ids[qi][ok].astype(np.int64),
                        vals[qi][ok].astype(np.float32)))
        return out

    def _dispatch_topk(self, term_groups, k: int, operator: str = "OR"):
        """Queue the device top-k without syncing; returns the device
        (vals, rows) pair (callers fetch in bulk)."""
        terms = [(tid, gi) for gi, group in enumerate(term_groups)
                 for tid in group if tid >= 0]
        n_present = len({gi for _, gi in terms})
        t_b, l_b, starts, lens, idf, gid = self._pack_terms(terms)
        g_b = _bucket(len(term_groups), lo=4)
        need = n_present if operator.upper() == "AND" else 1
        return _bm25_topk_program(
            self._doc_ids, self._tfs, self._doc_len,
            *_upload(starts, lens, idf, gid), self._avgdl(), need, t_b, l_b,
            g_b, self.n_docs, min(k, self.n_docs))


# ------------------------------------------------------------ impact layout
def _vector_distance(emb: torch.Tensor, Q: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """``[b, n_pad]`` f32 distances of the block's embedding slice to the
    query vectors (cosine: ``emb`` rows are pre-normalized). The product is a
    plain full-f32 ``torch.matmul`` (``backend`` keeps TF32 off), where the
    reference asks XLA for ``Precision.HIGHEST``."""
    if metric == "cosine":
        Q = Q / torch.clamp_min(
            torch.linalg.vector_norm(Q, dim=1, keepdim=True), 1e-30)
    dot = torch.matmul(Q, emb.T)
    if metric == "cosine":
        return 1.0 - dot
    if metric == "l2":
        e_sq = torch.sum(emb * emb, dim=1)[None, :]
        q_sq = torch.sum(Q * Q, dim=1)[:, None]
        return torch.sqrt(torch.clamp_min(e_sq - 2.0 * dot + q_sq, 0.0))
    return -dot                        # inner product distance


class ImpactBM25:
    """Dense doc-major scorer for batched serving: ``term_ids [N, L]`` (L =
    max terms per doc) and a precomputed per-(doc, slot) BM25 saturation
    ``sat = tf*(k1+1)/(tf+k1*(1-b+b*len/avgdl))``, so that
    Score(d, q) = sum_slots sum_terms eq * sat[d, slot] * idf[q, term]
    (``ops.impact_bm25``); padded docs, slots and terms never match (-2 vs
    -1 ids).

    Memory is N x L_pad x 8 bytes; blocks whose longest doc exceeds
    ``MAX_L`` slots keep the CSR paths (factory returns None)."""

    MAX_L = 512
    TILE = 2048

    @staticmethod
    def try_create(reader) -> "Optional[ImpactBM25]":
        counts = np.bincount(reader.doc_ids.astype(np.int64),
                             minlength=reader.n_docs) if reader.n_docs \
            else np.zeros(0, np.int64)
        if reader.n_docs == 0 or counts.max(initial=0) > ImpactBM25.MAX_L:
            return None
        return ImpactBM25(reader, counts)

    def __init__(self, reader, counts):
        r = reader
        self.reader = r
        self.n_docs = r.n_docs
        avgdl = float(r.doc_len.mean()) if r.n_docs else 1.0
        vocab = len(r.offsets) - 1
        df = (r.offsets[1:] - r.offsets[:-1]).astype(np.int64)
        self._df = df
        term_of = np.repeat(np.arange(vocab, dtype=np.int32), df)
        doc_of = r.doc_ids.astype(np.int64)
        order = np.argsort(doc_of, kind="stable")
        d_s, t_s = doc_of[order], term_of[order]
        tf_s = r.tfs[order].astype(np.float32)
        L = _bucket(int(counts.max(initial=1)), lo=8)
        n_pad = -(-r.n_docs // self.TILE) * self.TILE
        first = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(d_s), dtype=np.int64) - first[d_s]
        term_ids = np.full((n_pad, L), -2, np.int32)
        term_ids[d_s, slot] = t_s
        dl = r.doc_len.astype(np.float32)[d_s]
        sat = np.zeros((n_pad, L), np.float32)
        sat[d_s, slot] = tf_s * (K1 + 1.0) / (
            tf_s + K1 * (1.0 - B + B * dl / max(avgdl, 1e-9)))
        self.n_pad, self.L = n_pad, L
        self._term_ids = backend.to_device(term_ids)   # resident, once
        self._sat = backend.to_device(sat)

    def _idf(self, tid: int) -> float:
        df = float(self._df[tid])
        return float(np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)))

    def _pack_queries(self, queries: "List[List[List[int]]]",
                      operator: str):
        """Pad the batch's term groups to bucketed [b, m] device operands.
        A term's group travels as its index (``qgroup``, -1 on pad terms)
        where the reference builds a one-hot ``[b, m, g]`` matrix; the terms
        of one group are adjacent, which the scorer relies on."""
        terms_per_q = [[(tid, gi) for gi, grp in enumerate(q)
                        for tid in grp if tid >= 0] for q in queries]
        m = _bucket(max((len(t) for t in terms_per_q), default=1), lo=4)
        g = _bucket(max((len(q) for q in queries), default=1), lo=4)
        b = _bucket(len(queries), lo=1)
        qterms = np.full((b, m), -1, np.int32)
        idf = np.zeros((b, m), np.float32)
        qgroup = np.full((b, m), -1, np.int32)
        need = np.ones(b, np.float32)
        drop = np.zeros(b, np.bool_)
        for qi, (q, terms) in enumerate(zip(queries, terms_per_q)):
            for i, (tid, gi) in enumerate(terms):
                qterms[qi, i] = tid
                idf[qi, i] = self._idf(tid)
                qgroup[qi, i] = gi
            present = len({gi for _, gi in terms})
            if operator.upper() == "AND":
                need[qi] = float(len(q))
                drop[qi] = present < len(q)  # a group had no known terms
            else:
                need[qi] = 1.0
        return qterms, idf, qgroup, need, drop, b, m, g

    def dispatch_top_k_batch(self, queries: "List[List[List[int]]]",
                             k: int, operator: str = "OR"):
        """Queue the batch's scoring and top-k (one kernel) WITHOUT syncing;
        returns an opaque handle for :meth:`collect`. Callers serving
        multiple blocks dispatch them all, then collect: the card works on
        one block while the host packs the next."""
        qterms, idf, qgroup, need, drop, _, _, _ = \
            self._pack_queries(queries, operator)
        dev = impact_bm25_topk(
            self._term_ids, self._sat,
            *_upload(pack_query_terms(qterms, idf, qgroup), need),
            min(k, max(self.n_docs, 1)))
        return (dev, drop, len(queries))

    def collect(self, handle) -> "List[Tuple[np.ndarray, np.ndarray]]":
        dev, drop, b_real = handle
        vals, ids = _fetch_pair(*dev)
        out = []
        for qi in range(b_real):
            if drop[qi]:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
                continue
            ok = (vals[qi] > -np.inf) & (ids[qi] < self.n_docs)
            out.append((ids[qi][ok].astype(np.int64),
                        vals[qi][ok].astype(np.float32)))
        return out

    def top_k_batch(self, queries: "List[List[List[int]]]", k: int,
                    operator: str = "OR"
                    ) -> "List[Tuple[np.ndarray, np.ndarray]]":
        """One dense scoring for B queries -> [(rows, scores)] per query."""
        if len(queries) == 0:
            return []
        return self.collect(self.dispatch_top_k_batch(queries, k, operator))

    def dispatch_fused_top_k_batch(self, queries: "List[List[List[int]]]",
                                   k: int, operator: str, emb,
                                   Q: np.ndarray, w_score: float,
                                   w_dist: float, metric: str):
        """Queue the fused text+vector ranking without syncing (see
        :meth:`dispatch_top_k_batch`): the distance term is a matrix product
        outside the kernel, and the kernel ranks
        ``w_score * bm25 + w_dist * dist`` on the text-matched docs."""
        b_real = len(queries)
        qterms, idf, qgroup, need, drop, b, _, _ = \
            self._pack_queries(queries, operator)
        Qp = np.zeros((b, Q.shape[1]), np.float32)
        Qp[:b_real] = Q
        qpack, need_d, Qd = _upload(pack_query_terms(qterms, idf, qgroup),
                                    need, Qp)
        dev = impact_bm25_topk(
            self._term_ids, self._sat, qpack, need_d,
            min(k, max(self.n_docs, 1)),
            dist=_vector_distance(emb, Qd, metric),
            w_s=float(np.float32(w_score)), w_d=float(np.float32(w_dist)))
        return (dev, drop, b_real)

    def fused_top_k_batch(self, queries: "List[List[List[int]]]", k: int,
                          operator: str, emb, Q: np.ndarray,
                          w_score: float, w_dist: float, metric: str
                          ) -> "List[Tuple[np.ndarray, np.ndarray]]":
        """Fused text+vector ranking over the text-matched candidate set:
        returns per query the top-k rows by ``w_score*bm25 + w_dist*dist``
        (callers encode ASC orders by negating both weights). ``emb`` is
        this block's [n_pad, d] device-resident embedding slice (cosine:
        pre-normalized rows)."""
        if len(queries) == 0:
            return []
        return self.collect(self.dispatch_fused_top_k_batch(
            queries, k, operator, emb, Q, w_score, w_dist, metric))
