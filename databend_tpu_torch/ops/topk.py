"""K-select (port of ``databend_tpu/ops/topk.py``).

``lax.top_k(-d, k)`` becomes :func:`topk_smallest_lowest_index`: equal
distances rank by ascending position, as ``lax.top_k`` ranks them, where a
bare ``torch.topk`` keeps any of them. The reference's ``approx_min_k``
becomes the same exact selection: XLA lowers ``approx_min_k`` to an exact
top-k off the TPU, and the fused approximate selector of this port is the
flash kernel (``ops/flash_topk.py``). The streaming scan is a Python
loop that carries the running ``[B, k]`` set, the counterpart of the
reference's ``lax.scan``. Selectors carry ``(distance, id)`` pairs so merges
keep global row ids.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .distance import _dot, pairwise_distance

INF = float("inf")


def topk_smallest(dists: torch.Tensor, k: int,
                  ids: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k per row of ``dists [B, N]`` -> (values, indices) ``[B, k]``
    ascending. ``ids``: optional ``[N]`` or ``[B, N]`` global ids returned
    instead of positions. The reference's ``approx=True`` (``approx_min_k``)
    has no counterpart: its port is this exact selection."""
    vals, pos = topk_smallest_lowest_index(dists, k)
    if ids is not None:
        if ids.ndim == 1:
            return vals, ids[pos]
        return vals, torch.gather(ids, 1, pos)
    return vals, pos


def _stable_order(key: torch.Tensor, descending: bool, *rows: torch.Tensor):
    order = torch.sort(key, dim=1, descending=descending, stable=True).indices
    return [torch.gather(r, 1, order) for r in rows]


def _order_key(values: torch.Tensor) -> torch.Tensor:
    """The int32 image of float32 ``values`` that keeps their total order:
    -0.0 below +0.0, -inf below every finite value (no NaN)."""
    if values.dtype != torch.float32:
        raise TypeError(f"want float32 values, got {values.dtype}")
    bits = values.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_largest_lowest_index(values: torch.Tensor, k: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k per row of float32 ``values [B, N]`` (no NaN) -> (values,
    indices) ``[B, k]`` in ``jax.lax.top_k``'s order: by the total order of
    float32 descending (-0.0 ranks below +0.0) and, among equal values, by
    index ascending, and of the entries equal to the k-th value the ones with
    the lowest indices are kept. ``torch.topk`` promises neither, and BM25
    over short texts ties by the thousand.

    The selection runs on the order-preserving int32 image of the values
    (``_order_key``), where the two zeros differ. One ``torch.topk`` finds
    the k-th key; every entry above it is in that result whatever torch
    chose. A second ``torch.topk``, over ``N - index`` of the entries equal
    to the k-th key (distinct keys, so nothing is left to choice), finds
    their lowest indices. The ``[B, 2k]`` candidates are then ordered with
    stable sorts, and the values gathered from the input. No host
    synchronisation."""
    n = values.shape[1]
    keys = _order_key(values)
    top, idx = torch.topk(keys, k, dim=1)
    kth = top[:, -1:]
    from_end = torch.arange(n, 0, -1, dtype=torch.int32, device=values.device)
    tied = torch.where(keys == kth, from_end, 0)
    tied_idx = (n - torch.topk(tied, k, dim=1).values).to(idx.dtype)
    above = top > kth
    room = k - above.sum(1, keepdim=True)     # >= 1: the k-th entry itself
    tied_ok = torch.arange(k, device=values.device)[None, :] < room
    c_idx = torch.cat([idx, tied_idx], 1)
    c_key = torch.cat([top, kth.expand(-1, k)], 1)
    c_ok = torch.cat([above, tied_ok], 1).to(torch.int8)
    # least significant key first: index, then value, then validity
    c_idx, c_key, c_ok = _stable_order(c_idx, False, c_idx, c_key, c_ok)
    c_idx, c_key, c_ok = _stable_order(c_key, True, c_idx, c_key, c_ok)
    (c_idx,) = _stable_order(c_ok, True, c_idx)
    c_idx = c_idx[:, :k].contiguous()
    return torch.gather(values, 1, c_idx), c_idx


# rows of at most this many distances are ranked by one stable sort of
# their order keys (no host synchronisation); longer rows take torch.topk
SORT_MAX_N = 16384


def _select(dists: torch.Tensor, k: int):
    """(values, positions, tied) of the smallest k per row, in the order of
    :func:`topk_smallest_lowest_index` except on the rows flagged in
    ``tied`` (bool ``[B]`` on the device, None when no row can be), which
    that function selects again. No host synchronisation."""
    n = dists.shape[1]
    if n <= SORT_MAX_N:
        pos = torch.sort(_order_key(-dists), dim=1, descending=True,
                         stable=True).indices[:, :k]
        return torch.gather(dists, 1, pos), pos, None
    vals, pos = torch.topk(dists, min(k + 1, n), dim=1, largest=False)
    tied = vals[:, k] == vals[:, k - 1] if k < n else None
    key = _order_key(-vals[:, :k])
    pos, key = _stable_order(pos[:, :k], False, pos[:, :k], key)
    (pos,) = _stable_order(key, True, pos)
    return torch.gather(dists, 1, pos), pos, tied


def _select_tied(out, i: int, dists: torch.Tensor, flag: torch.Tensor,
                 done, k: int) -> None:
    """Select again, with the second selection, the rows of block ``i``
    that ``flag`` (a host copy of ``tied``, ready once ``done`` is) marks."""
    if done is not None:
        done.synchronize()
    if not bool(flag.any()):
        return      # no copy to the card: even an empty one waits for it
    rows = torch.nonzero(flag).flatten().to(dists.device)
    pos = out[i][1]
    _, pos[rows] = topk_largest_lowest_index(-dists[rows], k)
    out[i][0] = torch.gather(dists, 1, pos)


def topk_smallest_lowest_index_blocks(blocks: Iterable[torch.Tensor], k: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_smallest_lowest_index` of each float32 ``[b, N]`` block
    of ``blocks`` (a generator, say, that scores one query chunk at a time),
    the blocks' (values, positions) concatenated along the rows. A block's
    tied rows are read on the host one block later, from a copy the card
    makes once it has selected, so the host queues the next block's work
    before it waits and the card is not left idle between blocks; two
    blocks are alive at a time."""
    out, pending = [], None
    for dists in blocks:
        vals, pos, tied = _select(dists, k)
        out.append([vals, pos])
        if pending is not None:
            _select_tied(out, *pending, k)
            pending = None
        if tied is None:
            continue
        if dists.is_cuda:
            flag = torch.empty(tied.shape, dtype=tied.dtype, pin_memory=True)
            flag.copy_(tied, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            flag, done = tied, None
        pending = (len(out) - 1, dists, flag, done)
    if pending is not None:
        _select_tied(out, *pending, k)
    if len(out) == 1:
        return tuple(out[0])
    return (torch.cat([vals for vals, _ in out]),
            torch.cat([pos for _, pos in out]))


def topk_smallest_lowest_index(dists: torch.Tensor, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k per row of float32 ``dists [B, N]`` (no NaN) -> (values,
    positions) ``[B, k]`` in ``jax.lax.top_k(-dists, k)``'s order: equal
    distances by ascending position, the lowest positions kept at the k-th
    place, signed zeros as :func:`_order_key` orders ``-dists``.

    Rows of at most ``SORT_MAX_N`` entries (the flash shortlist and
    re-rank) are ranked whole by one stable sort of the order keys. Longer
    rows take one ``torch.topk`` of k + 1: where the (k+1)-th distance
    exceeds the k-th, the first k are the reference's set and only their
    order is fixed (two stable sorts of ``[B, k]``); the rows where the two
    are equal (a tie across the k-th place, or the two zeros) go through
    :func:`topk_largest_lowest_index`, after one host synchronisation to
    find them (:func:`topk_smallest_lowest_index_blocks` hides it behind
    the next block's work)."""
    return topk_smallest_lowest_index_blocks([dists], k)


def chunked_topk_smallest(q: torch.Tensor, x: torch.Tensor, k: int,
                          metric: str, chunk_rows: int = 131072,
                          compute_dtype=torch.float32,
                          x_sq_norms: Optional[torch.Tensor] = None,
                          base_id: int = 0,
                          n_valid: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan + score + k-select over ``x [N, d]`` in chunks of ``chunk_rows``:
    each chunk's scores fold into the running ``[B, k]`` set with one top-k
    over ``[B, k + chunk]``, so peak memory is one chunk, not ``[B, N]``.
    A ragged last chunk needs no padding.

    Equal distances rank by ascending row id, as ``jax.lax.top_k`` ranks
    them (:func:`topk_smallest_lowest_index`).

    ``n_valid``: rows with global id >= n_valid are padding and score +inf
    BEFORE selection (index masking is the only metric-safe pad exclusion).
    Returns (distances ``[B, k]``, global ids ``base_id + row``)."""
    n = x.shape[0]
    b = q.shape[0]
    dev = x.device
    if n <= chunk_rows:
        dists = pairwise_distance(q, x, metric, compute_dtype, x_sq_norms)
        ids = torch.arange(n, device=dev) + base_id
        if n_valid is not None:
            dists = torch.where(ids[None, :] < n_valid, dists, INF)
        vals, pos = topk_smallest_lowest_index(dists, min(k, n))
        return vals, ids[pos]
    best_v = torch.full((b, k), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, chunk_rows):
        xi = x[start:start + chunk_rows]
        ni = None if x_sq_norms is None else x_sq_norms[start:start + chunk_rows]
        dists = pairwise_distance(q, xi, metric, compute_dtype, ni)
        ids = torch.arange(xi.shape[0], device=dev) + (base_id + start)
        if n_valid is not None:
            dists = torch.where(ids[None, :] < n_valid, dists, INF)
        cat_v = torch.cat([best_v, dists], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_v, pos = topk_smallest_lowest_index(cat_v, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_v, best_i


def merge_topk(dists: torch.Tensor, ids: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard/per-block top-k lists (``[S, B, k_s]`` stacked or
    ``[B, S*k_s]`` concatenated) into one global top-k."""
    if dists.ndim == 3:
        s, b, ks = dists.shape
        dists = dists.permute(1, 0, 2).reshape(b, s * ks)
        ids = ids.permute(1, 0, 2).reshape(b, s * ks)
    vals, pos = topk_smallest_lowest_index(dists, min(k, dists.shape[1]))
    return vals, torch.gather(ids, 1, pos)


def pad_corpus(x, multiple: int):
    """Pad an ``[N, d]`` numpy corpus to a row multiple with large-magnitude
    rows placed after the real ones; returns (padded, n_valid)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.full((rem, x.shape[1]), 1e18, dtype=np.float32)
    return np.concatenate([np.asarray(x, dtype=np.float32), pad], axis=0), n


def brute_force_topk(q: torch.Tensor, x: torch.Tensor, k: int,
                     metric: str = "l2", chunk_rows: int = 131072,
                     bf16: bool = False,
                     x_sq_norms: Optional[torch.Tensor] = None):
    """End-to-end exact scan: score ``[B,d] x [N,d]`` + k-select."""
    cd = torch.bfloat16 if bf16 else torch.float32
    return chunked_topk_smallest(q, x, k, metric, chunk_rows=chunk_rows,
                                 compute_dtype=cd, x_sq_norms=x_sq_norms)


def rerank_topk(q: torch.Tensor, x_bf16: torch.Tensor,
                x_sq_norms: torch.Tensor, x_f32: torch.Tensor, k: int,
                metric: str = "l2",
                shortlist: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase top-k: a bf16 distance matmul over the whole corpus picks
    ``shortlist`` candidates (default 8k), whose f32 vectors are re-scored
    exactly before the final top-k. Metrics: l2, l2_sq, ip, cosine (pass a
    pre-normalized corpus and queries for cosine)."""
    if shortlist <= 0:
        shortlist = 8 * k
    q32 = q.float()
    dots = _dot(q, x_bf16, torch.bfloat16)                        # [B, N]
    if metric in ("l2", "l2_sq"):
        qq = torch.sum(q32 * q32, dim=-1, keepdim=True)
        approx_d = qq - 2.0 * dots + x_sq_norms[None, :]
    elif metric in ("ip", "cosine"):
        approx_d = -dots
    else:
        raise ValueError(f"rerank_topk: unsupported metric {metric!r}")
    _, cand = torch.topk(approx_d, shortlist, dim=1, largest=False)  # [B, S]

    cand_vecs = x_f32[cand]                                       # [B, S, d]
    if metric in ("l2", "l2_sq"):
        diff = cand_vecs - q32[:, None, :]
        exact = torch.sum(diff * diff, dim=-1)
        if metric == "l2":
            exact = torch.sqrt(torch.clamp_min(exact, 0.0))
    else:
        exact = -torch.einsum("bsd,bd->bs", cand_vecs, q32)
    vals, pos = topk_smallest_lowest_index(exact, k)
    return vals, torch.gather(cand, 1, pos)

