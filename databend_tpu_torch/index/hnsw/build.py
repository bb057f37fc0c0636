"""HNSW construction as dense tensor programs on torch (port of
``databend_tpu/index/hnsw/build.py``).

The reference derives the graph from dense linear algebra instead of
sequential insertion, and the port keeps that design stage by stage:

1. **Exact kNN graph** — every point's ``ef_construct`` nearest neighbours
   via chunked bf16 distance matmul + streaming k-select
   (``ops.topk.chunked_topk_smallest``, equal distances by ascending id).
2. **Vectorized neighbour-selection heuristic** — the hnswlib rule (keep
   candidate c iff d(c, p) < d(c, s) for every already-kept s) for a chunk
   of points at once: one ``[chunk, K, K]`` candidate-pairwise distance
   tensor and a K-step masked scan (a Python loop of K batched steps, the
   reference's ``fori_loop``).
3. **Reverse-edge pass + re-prune** — union forward and reverse edges on the
   host, distances + dedupe + stable sort on the device, the heuristic again.

Level structure matches the reference: geometric levels with factor
1/ln(m), m0 = 2m on level 0, m above, 2 entry points.

The reference pads chunk rows to powers of two and candidate columns to
multiples of 16 only to bound XLA recompiles; torch compiles nothing per
shape, so the port runs ragged chunks. Pads never change a link.

Each stage's wall seconds go to ``METRICS`` as ``hnsw_build_<stage>_seconds``
(every stage ends with its result on the host, so the clock sees the device
work).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ... import backend
from ...ops.distance import pairwise_distance
from ...ops.topk import chunked_topk_smallest
from ...utils.metrics import METRICS
from .graph import HnswGraph

INF = float("inf")

BUILD_STAGES = ("knn", "prune1", "reverse", "dedup_sort", "prune2", "upper")


@contextlib.contextmanager
def _stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        METRICS.observe(f"hnsw_build_{name}_seconds",
                        time.perf_counter() - t0)


def _search_metric(metric: str) -> str:
    # cosine vectors are pre-normalized; dot ordering == cosine ordering
    return "ip" if metric == "cosine" else metric


def _knn_batch(x: torch.Tensor, q: torch.Tensor, own: torch.Tensor, k: int,
               metric: str, chunk_rows: int):
    """One query batch of the all-pairs kNN: top-(k+1) then drop self."""
    dists, ids = chunked_topk_smallest(q, x, k + 1, metric,
                                       chunk_rows=chunk_rows,
                                       compute_dtype=torch.bfloat16)
    dists = torch.where(ids == own[:, None], INF, dists)
    # k smallest of k + 1, equal distances in position order
    vals, pos = torch.sort(dists, dim=1, stable=True)
    return vals[:, :k], torch.gather(ids, 1, pos[:, :k])


def _knn_graph_np(x_dev: torch.Tensor, n: int, k: int, metric: str,
                  q_chunk: int = 1024, chunk_rows: int = 65536):
    """Exact kNN of every row against the whole set (the reference's
    insertion-searches replaced by dense scans), in Python-driven query
    batches. Returns numpy (distances f32 [n, k], ids int32 [n, k])."""
    out_d = np.empty((n, k), np.float32)
    out_i = np.empty((n, k), np.int32)
    for s in range(0, n, q_chunk):
        e = min(s + q_chunk, n)
        own = torch.arange(s, e, device=x_dev.device)
        d, i = _knn_batch(x_dev, x_dev[s:e], own, k, metric, chunk_rows)
        out_d[s:e], out_i[s:e] = backend.to_numpy([d, i.int()])
    return out_d, out_i


def _heuristic_prune(x: torch.Tensor, cand_d: torch.Tensor,
                     cand_i: torch.Tensor, point_ids: torch.Tensor,
                     m_out: int, metric: str) -> torch.Tensor:
    """Vectorized hnswlib neighbor-selection heuristic.

    x: [n, d] full vector set (gather source, global ids)
    cand_d/cand_i: [b, K] candidates sorted by distance asc (global ids,
    -1 pad); distances in the comparison space of ``metric`` (squared for
    l2, negated dot for ip, raw for l1)
    point_ids: [b] global id of each point being linked
    Returns links [b, m_out] global ids (int64), -1 padded.
    """
    b, K = cand_i.shape
    cand_i = cand_i.long()
    cvecs = x[torch.clamp_min(cand_i, 0)].float()  # [b, K, d]
    # pairwise candidate-candidate distances [b, K, K]
    if metric == "ip":
        cc = -torch.einsum("bkd,bjd->bkj", cvecs, cvecs)
    elif metric == "l1":
        cc = None  # computed per-step to bound memory
    else:  # l2 family: squared distances preserve order
        sq = torch.sum(cvecs ** 2, dim=-1)
        cc = sq[:, :, None] - 2.0 * torch.einsum(
            "bkd,bjd->bkj", cvecs, cvecs) + sq[:, None, :]
        # cand_d is already squared by the caller (_prep_for_metric)
    valid = cand_i >= 0

    keep = torch.zeros((b, K), dtype=torch.bool, device=x.device)
    kept_n = torch.zeros(b, dtype=torch.int32, device=x.device)
    for j in range(K):
        # candidate j violates if some kept i has d(c_j, c_i) <= d(c_j, p)
        if cc is None:  # l1
            dj = torch.sum(torch.abs(cvecs - cvecs[:, j:j + 1, :]), -1)
        else:
            dj = cc[:, j, :]  # [b, K] distances from c_j to all candidates
        viol = torch.any(keep & (dj <= cand_d[:, j:j + 1]), dim=1)
        ok = (~viol) & (kept_n < m_out) & valid[:, j]
        keep[:, j] = ok
        kept_n += ok

    # compact kept ids to the front, pad with -1
    slot = torch.arange(K, device=x.device)[None, :]
    order = torch.argsort(torch.where(keep, slot, K), dim=1,
                          stable=True)[:, :m_out]
    return torch.gather(torch.where(keep, cand_i, -1), 1, order)


def _prep_for_metric(d: np.ndarray, metric: str) -> np.ndarray:
    """The heuristic compares candidate<->candidate vs candidate<->point
    distances in a consistent space: squared for l2, raw dot-negation for ip."""
    if metric == "l2":
        return d.astype(np.float32) ** 2
    return d.astype(np.float32)


def _select_links(x_dev: torch.Tensor, cand_d: np.ndarray, cand_i: np.ndarray,
                  point_ids: np.ndarray, m_out: int, metric: str,
                  chunk: int = 4096) -> np.ndarray:
    """The on-device heuristic over chunks of points; int32 [n, <= m_out]."""
    outs = []
    for s in range(0, cand_i.shape[0], chunk):
        e = s + chunk
        res = _heuristic_prune(
            x_dev, backend.to_device(_prep_for_metric(cand_d[s:e], metric)),
            backend.to_device(cand_i[s:e]), backend.to_device(point_ids[s:e]),
            m_out, metric)
        outs.append(backend.to_numpy(res.int()))
    return np.concatenate(outs, axis=0)


def _add_reverse_edges(links: np.ndarray, dists_lookup, m_out: int) -> np.ndarray:
    """Union forward links with reverse edges; returns cand_ids [n, C].

    Host-side regrouping (cheap integer sorts); distances recomputed on
    device by the caller for the re-prune.
    """
    n, m = links.shape
    src = np.repeat(np.arange(n, dtype=np.int32), m)
    dst = links.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    # reverse edges grouped by destination
    order = np.argsort(dst, kind="stable")
    rdst, rsrc = dst[order], src[order]
    counts = np.bincount(rdst, minlength=n)
    max_rev = int(counts.max()) if len(counts) else 0
    cap = min(max_rev, 2 * m_out)
    rev = np.full((n, cap), -1, dtype=np.int32)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    for i in range(cap):
        has = counts > i
        rev[has, i] = rsrc[offs[:-1][has] + i]
    # union forward + reverse; the device pass dedupes per row
    return np.concatenate([links, rev], axis=1)


def _dedup_and_sort_by_distance(x_dev: torch.Tensor, union: np.ndarray,
                                point_ids: np.ndarray, metric: str,
                                chunk: int = 8192):
    """Device pass: distances point->candidates, dedup, sort asc.
    Returns (cand_d, cand_i) numpy arrays."""
    n, C = union.shape
    out_d = np.empty((n, C), np.float32)
    out_i = np.empty((n, C), np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d, i = _dedup_sort_kernel(x_dev, backend.to_device(union[s:e]),
                                  backend.to_device(point_ids[s:e]), metric)
        out_d[s:e], out_i[s:e] = backend.to_numpy([d, i.int()])
    return out_d, out_i


def _dedup_sort_kernel(x: torch.Tensor, ids: torch.Tensor,
                       pids: torch.Tensor, metric: str):
    """ids [b, C] candidates of points pids [b] -> (distances, ids) sorted
    ascending by distance (stable), with padding, self and repeated ids
    (all but the first occurrence) turned into (+inf, -1)."""
    C = ids.shape[1]
    ids = ids.long()
    pids = pids.long()
    cv = x[torch.clamp_min(ids, 0)].float()  # [b, C, d]
    pv = x[pids].float()                     # [b, d]
    if metric == "ip":
        d = -torch.einsum("bcd,bd->bc", cv, pv)
    elif metric == "l1":
        d = torch.sum(torch.abs(cv - pv[:, None, :]), -1)
    else:  # l2
        diff = cv - pv[:, None, :]
        d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, -1), 0.0))
    # invalidate padding, self, and duplicates (keep first occurrence):
    # a duplicate has an equal id at an earlier column
    col = torch.arange(C, device=x.device)
    eq_earlier = (ids[:, :, None] == ids[:, None, :]) & (
        col[None, None, :] < col[None, :, None])
    bad = (ids < 0) | (ids == pids[:, None]) | eq_earlier.any(dim=2)
    d, order = torch.sort(torch.where(bad, INF, d), dim=1, stable=True)
    return d, torch.gather(torch.where(bad, -1, ids), 1, order)


def assign_levels(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Geometric level assignment, factor 1/ln(m), capped at 16."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    levels = np.floor(-np.log(np.maximum(u, 1e-12)) / math.log(m)).astype(np.int32)
    return np.minimum(levels, 16)


def build_hnsw(vectors: np.ndarray, m: int = 16, ef_construct: int = 100,
               metric: str = "cosine", seed: int = 0) -> HnswGraph:
    """Build an HNSW graph for one block's vector column.

    Defaults mirror the reference (vector_index_writer.rs:54-55): m=16,
    ef_construct=100, m0=2m, entry_points=2.
    """
    x = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = x.shape
    m0 = 2 * m
    smetric = _search_metric(metric)
    if metric == "cosine":
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        x = x / np.maximum(norms, 1e-30)

    levels = assign_levels(n, m, seed)
    # tiny blocks: fully connected level 0
    if n <= m0 + 1:
        links0 = np.full((n, m0), -1, np.int32)
        for i in range(n):
            others = np.array([j for j in range(n) if j != i], np.int32)
            links0[i, : len(others)] = others
        ep = np.array([int(np.argmax(levels)), 0], np.int32)[:2]
        return HnswGraph(metric, m, ef_construct, ep, [links0], [None])

    x_dev = backend.to_device(x)
    # ---- level 0: exact kNN + heuristic + reverse edges -------------------
    K = int(min(max(ef_construct, m0), n - 1))
    with _stage("knn"):
        knn_d, knn_i = _knn_graph_np(x_dev, n, K, smetric)
    point_ids = np.arange(n, dtype=np.int32)
    with _stage("prune1"):
        fwd = _select_links(x_dev, knn_d, knn_i, point_ids, m0, smetric)
    with _stage("reverse"):
        union = _add_reverse_edges(fwd, None, m0)
    with _stage("dedup_sort"):
        ud, ui = _dedup_and_sort_by_distance(x_dev, union, point_ids, smetric)
    with _stage("prune2"):
        links0 = _select_links(x_dev, ud, ui, point_ids, m0, smetric)

    links: List[np.ndarray] = [links0]
    level_ids: List[Optional[np.ndarray]] = [None]

    # ---- upper levels ------------------------------------------------------
    with _stage("upper"):
        max_level = int(levels.max())
        for l in range(1, max_level + 1):
            members = np.nonzero(levels >= l)[0].astype(np.int32)
            if len(members) < 2:
                max_level = l - 1
                break
            sub = x[members]
            nl = len(sub)
            kl = int(min(ef_construct, nl - 1))
            sub_dev = backend.to_device(sub)
            if nl <= 2048:
                dists = backend.to_numpy(
                    pairwise_distance(sub_dev, sub_dev, smetric)).copy()
                np.fill_diagonal(dists, np.inf)
                order = np.argsort(dists, axis=1)[:, :kl]
                cd = np.take_along_axis(dists, order, axis=1)
                ci = members[order]
            else:
                cd, ci_local = _knn_graph_np(sub_dev, nl, kl, smetric)
                ci = members[ci_local]
            links.append(_select_links(x_dev, cd, ci, members, m, smetric))
            level_ids.append(members)

    links = links[: max_level + 1]
    level_ids = level_ids[: max_level + 1]

    # entry points: 2 highest-level points (reference entry_points_num=2)
    top_level_members = level_ids[-1] if max_level > 0 else np.arange(n, dtype=np.int32)
    eps = top_level_members[:2].astype(np.int32)
    return HnswGraph(metric, m, ef_construct, eps, links, level_ids)
