"""Query-batched HNSW beam search on torch (port of
``databend_tpu/index/hnsw/search.py``).

The reference runs the search as fixed-shape XLA programs amortised over a
query batch; the port keeps every array of that design and drives the two
``lax.while_loop``s from Python:

* the ef candidate queue  -> sorted ``[B, ef]`` (distance, id, expanded)
  tensors, merged with each expansion's neighbours by one stable sort;
* the visited list        -> a ``[B, n + 1]`` boolean mask (the last column
  takes the writes of pads and of neighbours already seen);
* the best-first loop     -> a Python loop that tests the batch's
  ``any(active)`` flag every step (one device->host sync a step). The loop
  runs for EVERY query while any is active, and a query's answer depends on
  the step the batch stops at, so the flag is read each step, as the
  reference's ``cond`` reads it;
* upper-layer descent     -> greedy beam-1, batched, the same loop shape;
* distance evaluation     -> gather the neighbours' vectors + batched
  dot / l2 in full float32 (TF32 is off, see ``backend``).

Ties follow the reference: ``lax.top_k(-d, ef)`` is a stable ascending sort
cut at ``ef`` (``torch.topk`` promises no order among equals, and the +inf
pads tie by the dozen every step), ``argsort`` is stable and ``argmin``
takes the first minimum.

ef defaults to 4*k like the reference (hnsw.rs:108).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import backend
from ...ops.distance import normalize
from ...utils.metrics import METRICS
from .graph import HnswGraph

INF = float("inf")


def _batch_dist(q: torch.Tensor, vecs: torch.Tensor,
                metric: str) -> torch.Tensor:
    """q [B, d] x vecs [B, M, d] -> [B, M] distances (per-row)."""
    q32 = q.float()
    v32 = vecs.float()
    if metric == "ip":
        return -torch.einsum("bd,bmd->bm", q32, v32)
    if metric == "l1":
        return torch.sum(torch.abs(v32 - q32[:, None, :]), -1)
    diff = v32 - q32[:, None, :]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, -1), 0.0))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, W], idx [B] -> a[b, idx[b]]."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _greedy_descent(x, links, level_pos, q, entry, metric, max_steps=64):
    """Beam-1 greedy walk on one upper level (reference search_entry,
    graph_layers.rs:132). links: [n_l, m] global ids; level_pos: [n]
    global->slot map (-1 if absent). Returns improved entry ids [B] and
    their distances."""
    cur = entry.long()
    cur_d = _batch_dist(q, x[cur][:, None, :], metric)[:, 0]
    improved = None  # every query counts as improved before the first step
    steps = 0
    while steps < max_steps and (improved is None or bool(improved.any())):
        slots = level_pos[cur].long()                       # [B]
        nbrs = links[torch.clamp_min(slots, 0)].long()      # [B, m]
        valid = (nbrs >= 0) & (slots >= 0)[:, None]
        vecs = x[torch.clamp_min(nbrs, 0)]
        nd = torch.where(valid, _batch_dist(q, vecs, metric), INF)
        best_d, best = torch.min(nd, dim=1)                 # first minimum
        improved = best_d < cur_d
        cur = torch.where(improved, _take(nbrs, best), cur)
        cur_d = torch.where(improved, best_d, cur_d)
        steps += 1
    return cur, cur_d


def _search_level0(x, links0, q, entry_ids, ef: int, k: int, metric: str,
                   max_steps: int):
    """ef-bounded best-first search on level 0 (reference _search_on_level,
    graph_layers.rs:73), batched over queries. Returns (distances [B, k],
    ids [B, k] int64, steps taken)."""
    b = q.shape[0]
    n = links0.shape[0]
    dev = q.device
    entry_ids = entry_ids.long()

    e = entry_ids.shape[1]  # seeded entries per query
    ef = max(ef, e)  # tiny blocks: never fewer candidate slots than seeds
    seed_d = _batch_dist(q, x[entry_ids], metric)  # [B, e]
    # dedupe identical seeds
    ar = torch.arange(e, device=dev)
    dup = (entry_ids[:, :, None] == entry_ids[:, None, :]) & (
        ar[None, None, :] < ar[None, :, None])
    seed_d = torch.where(dup.any(dim=2), INF, seed_d)

    pad = ef - e
    cand_d = torch.cat([seed_d, torch.full((b, pad), INF, device=dev)], dim=1)
    cand_i = torch.cat([entry_ids, torch.full((b, pad), -1, dtype=torch.int64,
                                              device=dev)], dim=1)
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    cand_i = torch.gather(cand_i, 1, order)
    expanded = cand_i < 0  # padding counts as expanded

    # column n is never read: it takes the writes of pads and seen
    # neighbours, so every write of the step's scatter stores True and
    # duplicate indices cannot disagree
    visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    visited.scatter_(1, entry_ids, True)

    steps = 0
    while steps < max_steps:
        frontier = torch.where(expanded, INF, cand_d)
        # closest unexpanded candidate and its position (first minimum)
        best_unexp, idx = torch.min(frontier, dim=1)
        # stop when every query's closest unexpanded is worse than its
        # worst retained candidate (or queue exhausted)
        if not bool((best_unexp <= cand_d[:, -1]).any()):
            break
        has_work = best_unexp < INF
        expanded.scatter_(1, idx[:, None], True)

        cur = _take(cand_i, idx)                                 # [B]
        nbrs = links0[torch.clamp_min(cur, 0)].long()            # [B, m0]
        safe = torch.clamp_min(nbrs, 0)
        seen = torch.gather(visited, 1, safe)
        fresh = (nbrs >= 0) & (~seen) & has_work[:, None]
        visited.scatter_(1, torch.where(fresh, safe, n), True)

        nd = torch.where(fresh, _batch_dist(q, x[safe], metric), INF)
        # fold new candidates into the queue: concat + ef smallest, equal
        # distances in position order (lax.top_k's rule)
        all_d = torch.cat([cand_d, nd], dim=1)
        all_i = torch.cat([cand_i, torch.where(fresh, nbrs, -1)], dim=1)
        all_e = torch.cat([expanded, nd >= INF], dim=1)
        all_d, pos = torch.sort(all_d, dim=1, stable=True)
        pos = pos[:, :ef]
        cand_d = all_d[:, :ef]
        cand_i = torch.gather(all_i, 1, pos)
        expanded = torch.gather(all_e, 1, pos)
        steps += 1

    return cand_d[:, :k], cand_i[:, :k], steps


def hnsw_search(graph: HnswGraph, x_dev, q: np.ndarray, k: int,
                ef: Optional[int] = None,
                max_steps: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Search a block's HNSW graph for a batch of queries.

    x_dev: the block's [n, d] vector column as a tensor on
    ``backend.device()`` (pre-normalized by the caller when graph.metric ==
    'cosine'; rows past ``graph.num_points`` are ignored). Returns
    (distances f32 [B, k], ids int32 [B, k]) as numpy, in the graph's
    *internal* ordering convention: cosine returns dot-ordering distances
    (negated dot) — callers postprocess via :func:`postprocess_scores`
    (reference hnsw.rs:317-339).
    """
    n = graph.num_points
    ef = ef or max(4 * k, k)  # reference: ef = limit * 4 (hnsw.rs:108)
    ef = min(max(ef, k), max(n, 1))
    metric = "ip" if graph.metric == "cosine" else graph.metric
    qd = backend.to_device(np.ascontiguousarray(q, np.float32))
    if graph.metric == "cosine":
        qd = normalize(qd)

    b = qd.shape[0]
    entry = backend.to_device(
        np.asarray(graph.entry_points[:1], np.int64)).expand(b)
    # descend upper levels (top -> 1)
    for l in range(graph.num_levels - 1, 0, -1):
        level_pos = np.full(n, -1, np.int32)
        level_pos[graph.level_ids[l]] = np.arange(len(graph.level_ids[l]), dtype=np.int32)
        entry, _ = _greedy_descent(x_dev, backend.to_device(graph.links[l]),
                                   backend.to_device(level_pos), qd, entry, metric)

    # seed level-0 queue with the descended entry + global entry points
    seeds = [entry[:, None]]
    for epid in graph.entry_points[:2]:
        seeds.append(torch.full((b, 1), int(epid), dtype=torch.int64,
                                device=qd.device))
    entry_ids = torch.cat(seeds, dim=1)

    limit = max_steps or (2 * ef + 16)
    dists, ids, steps = _search_level0(
        x_dev, backend.to_device(graph.links[0]), qd, entry_ids, ef,
        min(k, ef), metric, limit)
    METRICS.inc("hnsw_search_batches")
    METRICS.inc("hnsw_search_steps", steps)
    dists, ids = backend.to_numpy([dists, ids.int()])  # one fetch
    return dists, ids


def postprocess_scores(dists: np.ndarray, metric: str) -> np.ndarray:
    """Map internal search distances to SQL distance-function values
    (reference hnsw.rs:317-339): cosine -> 1 + negated-dot, others identity."""
    if metric == "cosine":
        return 1.0 + dists  # internal = -dot(normalized)
    return dists
