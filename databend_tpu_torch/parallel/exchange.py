"""General-plan distributed execution: the exchange operators (port of
``databend_tpu/parallel/exchange.py``).

The reference fragments arbitrary physical plans at exchange points and
ships Arrow Flight streams between nodes (reference:
schedulers/fragments/fragmenter.rs:238-266 — Shuffle | Merge | Expansive
(broadcast); servers/flight/v1/exchange/exchange_manager.rs:168). Here every
one of those data movements is a collective over the device mesh
(``mesh.py``):

* Merge exchange      -> per-shard partials + ``psum``/``pmax``/``pmin``
                         (grouped aggregation), or per-shard top-n +
                         ``all_gather`` + final select (ordered merge)
* Broadcast exchange  -> replicated build side, per-shard lookup join
* Shuffle exchange    -> ``all_to_all`` repartition by key hash so equal
                         keys land on one shard (large-large joins,
                         shuffle aggregation)

Keys are turned into dense global int codes on the host (pipeline/keys
factorization — the exchange hash function analog); the per-shard phases
are fixed-shape torch programs with padding + validity masks where row
counts vary. The reference's programs are ``shard_map`` bodies over a mesh
whose ``dp`` rows repeat the same work; the port runs them on dp row 0,
each process on the positions it owns (``mesh.per_shard``). A result the
reference all-gathers so that every host of a multi-process mesh can
address it is gathered the same way before it is read (``_fetch``), so
every process returns the same rows. Accumulation is f32 and
ids int32, as in the reference (JAX without x64): 64-bit host inputs land
as their 32-bit types, and the returned arrays have the reference's dtypes.
Every host decision (capacities, the skew guard) is taken before the first
upload; from the upload on, errors propagate.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import backend
from ..ops.topk import topk_largest_lowest_index
from .mesh import (SHARD_AXIS, P, all_shards, all_to_all, first_local,
                   from_blocks, gather, per_shard, pmax, pmin, psum,
                   put_sharded, unzip)

# --------------------------------------------------------------- helpers


def pad_rows(arr: np.ndarray, multiple: int, fill=0):
    """Pad axis 0 to a multiple; returns (padded, n_valid)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_shape = (rem,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]), n


def shard_rows_padded(mesh, arr: np.ndarray, fill=0):
    """Row-shard a host array over the mesh's shard axis, padding to an
    even split. Returns (sharded value, n_valid)."""
    s = mesh.shape[SHARD_AXIS]
    padded, n = pad_rows(arr, s, fill)
    spec = P(SHARD_AXIS, *([None] * (padded.ndim - 1)))
    return put_sharded(padded, mesh, spec), n


def _fetch(parts: Sequence) -> np.ndarray:
    """Per-shard results concatenated along axis 0 on the host, the other
    processes' shards gathered first (the reference's trailing
    ``all_gather``)."""
    return backend.to_numpy(gather(parts, tiled=True))


_IDENTITY = {"count": 0.0, "sum": 0.0, "min": float("inf"),
             "max": float("-inf")}


def _segment(op: str, v: torch.Tensor, g: torch.Tensor, n_seg: int
             ) -> torch.Tensor:
    """``jax.ops.segment_{sum,min,max}(v, g, num_segments=n_seg)`` (a count
    sums its 1s): ids outside [0, n_seg) are dropped, empty segments hold
    the identity."""
    if op not in _IDENTITY:
        raise ValueError(op)
    ok = (g >= 0) & (g < n_seg)
    g = torch.where(ok, g, 0).to(torch.int64)
    v = torch.where(ok, v, _IDENTITY[op])
    out = torch.full((n_seg,), _IDENTITY[op], dtype=v.dtype, device=v.device)
    if op in ("count", "sum"):
        return out.index_add_(0, g, v)
    return out.scatter_reduce_(0, g, v, "amin" if op == "min" else "amax",
                               include_self=True)


def _bucket_slots(dest: torch.Tensor, s: int, capacity: int,
                  ok: torch.Tensor) -> torch.Tensor:
    """The flat send-buffer slot ``dest * capacity + within`` of each row of
    a run sorted by destination (``within`` = its rank inside the run), and
    the spare slot ``s * capacity`` for rows not ``ok``: a row without a
    slot is dropped (``mode="drop"``), never written over a real row."""
    start = torch.searchsorted(dest, torch.arange(s, dtype=dest.dtype,
                                                  device=dest.device))
    within = torch.arange(dest.shape[0], device=dest.device) \
        - start[torch.clamp(dest, 0, s - 1)]
    ok = ok & (within < capacity)
    return torch.where(ok, dest.to(torch.int64) * capacity + within,
                       s * capacity)


def _scatter(slots: torch.Tensor, vals: torch.Tensor, n_slots: int, fill
             ) -> torch.Tensor:
    """A buffer of ``n_slots`` rows of ``fill`` with ``vals`` at ``slots``
    (the spare last slot absorbs the dropped rows and is cut off)."""
    buf = torch.full((n_slots + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    buf[slots] = vals
    return buf[:n_slots]


# ----------------------------------------------------- pipe width resize


def resize_width(mesh, x, n_valid: int, width: int, fill=0):
    """``Pipeline::resize`` analog (reference src/query/pipeline/src/core/
    pipeline.rs resize pipes): change an operator chain's parallel width
    mid-pipeline. A row-sharded value whose valid rows are a global prefix
    is re-packed so that prefix occupies exactly ``width`` of the mesh's
    shard slots (the remaining shards hold only fill); widening re-spreads
    it back. The data never returns to host: each new block is cut from
    the old blocks it overlaps, moved to its device (another process's
    blocks are read with one gather first).

    Returns ``(y, rows_per_shard)``: ``y`` keeps the ``P(shard)``
    sharding so downstream stages just run at the new width (slots >=
    width see only fill and must mask, exactly like the reference's dummy
    ports on a narrowed pipe).
    """
    s = mesh.shape[SHARD_AXIS]
    if not 1 <= width <= s:
        raise ValueError(f"width {width} not in [1, {s}]")
    if x.shape[0] % s:
        raise ValueError("input rows must already be mesh-divisible")
    cap = -(-max(int(n_valid), 1) // width)
    old = all_shards(x.shards())
    rows_in = x.shape[0] // s
    fill = float(fill) if isinstance(fill, np.ndarray) else fill

    def block(i, j):
        lo, hi = j * cap, (j + 1) * cap
        dev = mesh.devices[i, j]
        pieces = [blk[max(lo, b * rows_in) - b * rows_in:
                      min(hi, (b + 1) * rows_in) - b * rows_in]
                  .to(dev, non_blocking=True)
                  for b, blk in enumerate(old)
                  if max(lo, b * rows_in) < min(hi, (b + 1) * rows_in)]
        got = sum(p.shape[0] for p in pieces)
        if got < cap:
            pieces.append(torch.full((cap - got,) + tuple(old[0].shape[1:]),
                                     fill, dtype=old[0].dtype, device=dev))
        return torch.cat(pieces)

    y = from_blocks(mesh, x.spec, (s * cap,) + tuple(x.shape[1:]), block)
    return y, cap


def rebalance(mesh, x, n_valid: int, fill=0):
    """Full-width resize: even out per-shard load after an upstream stage
    changed the row count (the reference resizes after filters for the
    same reason)."""
    return resize_width(mesh, x, n_valid, mesh.shape[SHARD_AXIS],
                        fill=fill)


# ------------------------------------------------- grouped merge aggregate

_COLLECTIVE = {"count": psum, "sum": psum, "min": pmin, "max": pmax}


def sharded_grouped_agg(mesh, gids: np.ndarray, values: np.ndarray,
                        n_groups: int, ops: Sequence[str]) -> np.ndarray:
    """Distributed GROUP BY: rows (global group codes + agg inputs) are
    sharded over the mesh; each shard segment-aggregates its rows into a
    dense [G, n_aggs] state and the states merge with psum/pmin/pmax (the
    grouped Merge exchange; gid -1 = padding row).

    ``ops[j]`` in sum|count|min|max applies to values[:, j].
    Returns the merged [n_groups, len(ops)] f32 array. Accumulation runs at
    f32, as in the reference (callers needing exact f64 sums run the host
    path).
    """
    gids_dev, _ = shard_rows_padded(mesh, gids.astype(np.int32), fill=-1)
    vals_dev, _ = shard_rows_padded(
        mesh, np.ascontiguousarray(values, np.float64))
    g_parts, v_parts = gids_dev.shards(), vals_dev.shards()
    n_groups = int(n_groups)
    outs = []
    for j, op in enumerate(ops):
        def partial(_, g, v, j=j, op=op):
            valid = g >= 0
            col = valid.to(v.dtype) if op == "count" else v[:, j]
            return _segment(op, col, torch.where(valid, g, -1), n_groups)
        outs.append(first_local(
            _COLLECTIVE[op](per_shard(partial, g_parts, v_parts))))
    return backend.to_numpy(torch.stack(outs, dim=1))


# ------------------------------------------------------ ordered merge top-n


def _top_k(sel: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of a 1-d f32 value: largest first, equal values by
    ascending position."""
    vals, pos = topk_largest_lowest_index(sel[None], k)
    return vals[0], pos[0]


def sharded_topn(mesh, keys: np.ndarray, n: int, asc: bool = True
                 ) -> np.ndarray:
    """Distributed ORDER BY <key> LIMIT n over a row-sharded key column:
    per-shard top-n, all_gather of (key, global row id), final n-select —
    the reference's ordered merge exchange (exchange_sorting.rs).

    Returns the global row ids (int32) of the top n rows in sort order.
    NaN/NULL keys should be pre-filtered or mapped to +/-inf by the caller.
    """
    ids = np.arange(keys.shape[0], dtype=np.int32)
    fill = np.inf if asc else -np.inf
    keys_dev, _ = shard_rows_padded(mesh, keys.astype(np.float32), fill=fill)
    ids_dev, _ = shard_rows_padded(mesh, ids, fill=-1)

    def local(_, kl, il):
        vals, pos = _top_k(-kl if asc else kl, min(int(n), kl.shape[0]))
        return vals, il[pos]

    sel_parts, id_parts = unzip(per_shard(local, keys_dev.shards(),
                                          ids_dev.shards()), 2)
    all_v = gather(sel_parts).reshape(-1)
    all_i = gather(id_parts).reshape(-1)
    _, out_pos = _top_k(all_v, min(int(n), all_v.shape[0]))
    out = backend.to_numpy(all_i[out_pos])
    return out[out >= 0][:n]


# ------------------------------------------------------- broadcast join


def broadcast_lookup_join(mesh, probe_codes: np.ndarray,
                          build_codes: np.ndarray) -> np.ndarray:
    """Broadcast (Expansive) exchange join for unique-key build sides:
    the build side's key codes replicate to every shard; each shard binary-
    searches its probe rows. Returns per-probe-row build row index (int32)
    or -1.

    ``probe_codes``/``build_codes`` are dense global codes from a shared
    factorization (negative = NULL, never matches). Build keys must be
    unique (the PK/dimension-table case the reference broadcasts too).
    """
    order = np.argsort(build_codes, kind="stable").astype(np.int32)
    build_sorted = build_codes[order].astype(np.int64)
    probe_dev, n = shard_rows_padded(
        mesh, probe_codes.astype(np.int64), fill=-1)
    bs = put_sharded(build_sorted, mesh, P())
    bp = put_sharded(order, mesh, P())

    def local(_, probe, b_sorted, b_perm):
        pos = torch.searchsorted(b_sorted, probe)
        pos = torch.clamp(pos, 0, b_sorted.shape[0] - 1)
        hit = b_sorted[pos] == probe
        return torch.where(hit & (probe >= 0), b_perm[pos], -1)

    return _fetch(per_shard(local, probe_dev.shards(), bs.shards(),
                            bp.shards()))[:n]


# ------------------------------------------------------- shuffle exchange


def _shuffle_send(dest: torch.Tensor, cols: Sequence[torch.Tensor], s: int,
                  capacity: int, ok_rows: torch.Tensor, fills
                  ) -> List[torch.Tensor]:
    """One shard's send buffers: rows stably sorted by destination shard,
    each ``cols`` tensor scattered into ``[s, capacity, ...]`` (bucket i
    for shard i); rows not ``ok_rows`` (after the sort's permutation is
    applied to it) or beyond capacity are dropped."""
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    slots = _bucket_slots(torch.clamp(dest_s, max=s - 1), s, capacity,
                          ok_rows[order])
    return [_scatter(slots, c[order], s * capacity, f)
            .reshape((s, capacity) + tuple(c.shape[1:]))
            for c, f in zip(cols, fills)]


def _send_rows(dest_dev, vals_dev, s: int, capacity: int) -> List[list]:
    """Each shard's send buffers of a row shuffle to ``dest`` (rows with
    dest -1 dropped) and their validity buffers, as two per-shard
    lists."""
    def send(_, d, v):
        return _shuffle_send(
            d, [v, torch.ones(d.shape, dtype=torch.bool, device=d.device)],
            s, capacity, d >= 0, (0.0, False))
    return unzip(per_shard(send, dest_dev.shards(), vals_dev.shards()), 2)


def _shuffle_capacity(dest_padded: np.ndarray, s: int) -> int:
    """Worst-case rows one shard sends to one destination, vectorized
    over the whole padded dest array (no per-shard host loop)."""
    per_shard = dest_padded.shape[0] // s
    src = np.arange(dest_padded.shape[0]) // per_shard
    valid = dest_padded >= 0
    if not valid.any():
        return 1
    counts = np.bincount(src[valid] * s + dest_padded[valid],
                         minlength=s * s)
    return max(int(counts.max()), 1)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def shuffle_by_key(mesh, key_codes: np.ndarray, values: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffle (Normal/hash) exchange: repartition rows so equal key codes
    land on the same shard — the prerequisite for large-large shuffle
    joins and shuffle aggregation (reference fragmenter.rs:209 hash
    shuffle, servers/flight .. exchange_transform_shuffle.rs). Each shard
    sorts its rows into per-destination buckets of a fixed capacity (the
    host picks the global max bucket size) and ``all_to_all`` exchanges
    bucket i with shard i.

    Returns (key_codes' int64, values' f32, shard_of_row') as host arrays —
    the co-partitioned rows with their owning shard id, so the caller can
    verify placement or run per-shard logic next.
    """
    s = mesh.shape[SHARD_AXIS]
    dest = np.where(key_codes >= 0, key_codes % s, -1).astype(np.int32)
    cols = np.column_stack([key_codes.astype(np.float64),
                            np.ascontiguousarray(values, np.float64)])
    capacity = _shuffle_capacity(pad_rows(dest, s, fill=-1)[0], s)
    dest_dev, n = shard_rows_padded(mesh, dest, fill=-1)
    vals_dev, _ = shard_rows_padded(mesh, cols)
    bufs, valids = _send_rows(dest_dev, vals_dev, s, capacity)
    recv = _fetch(per_shard(lambda _, r: r.reshape(-1, cols.shape[1]),
                            all_to_all(bufs)))
    valid = _fetch(per_shard(lambda _, r: r.reshape(-1),
                             all_to_all(valids)))
    shard_of = np.repeat(np.arange(s), recv.shape[0] // s)
    keys_out = recv[valid, 0].astype(np.int64)
    vals_out = recv[valid, 1:]
    return keys_out, vals_out, shard_of[valid]


# ------------------------------------------- shuffle grouped aggregation


def _skewed(dest_padded: np.ndarray, s: int) -> Tuple[bool, int]:
    """The shuffle's bucket capacity, and whether one destination would
    receive most of the data (send buffers past ~4x the input)."""
    capacity = _next_pow2(_shuffle_capacity(dest_padded, s))
    per_shard = dest_padded.shape[0] // s
    return capacity > max(4 * per_shard // s, 1024), capacity


def shuffle_agg_local(gids: torch.Tensor, vals: torch.Tensor, s: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's send buffers of the shuffle aggregate: rows bucketed by
    ``gid % s`` (gid -1 = padding, dropped)."""
    dest = torch.where(gids >= 0, gids % s, s)
    return _shuffle_send(dest, [gids, vals], s, capacity, gids >= 0,
                         (-1, 0.0))


def sharded_shuffle_grouped_agg(mesh, gids: np.ndarray, values: np.ndarray,
                                n_groups: int, ops: Sequence[str]
                                ) -> Optional[np.ndarray]:
    """High-cardinality distributed GROUP BY via the shuffle exchange: rows
    all_to_all-shuffled by ``gid % s`` so each group lands wholly on its
    owner shard, then a per-shard segment reduce over the owner-local group
    range. Unlike the psum merge no shard ever materializes the dense
    global [G] state — communication is the row data, which wins when G is
    large (the reference's FragmentKind::Normal hash shuffle for
    high-cardinality GROUP BY, fragmenter.rs:209-266).

    Returns the merged [n_groups, len(ops)] f32 array (group order = gid),
    or None under pathological skew (one destination would receive most of
    the data — the psum/host paths handle that better).
    """
    s = mesh.shape[SHARD_AXIS]
    gids32 = gids.astype(np.int32)
    padded = pad_rows(gids32, s, fill=-1)[0]
    dest = np.where(padded >= 0, padded % s, -1).astype(np.int32)
    skewed, capacity = _skewed(dest, s)
    if skewed:
        return None  # skew guard, decided before any upload
    gps = _next_pow2((int(n_groups) + s - 1) // s)
    gids_dev, _ = shard_rows_padded(mesh, gids32, fill=-1)
    vals_dev, _ = shard_rows_padded(
        mesh, np.ascontiguousarray(values, np.float32))
    sent = per_shard(lambda _, g, v: shuffle_agg_local(g, v, s, capacity),
                     gids_dev.shards(), vals_dev.shards())
    m = len(ops)
    rgs, rvs = (all_to_all(t) for t in unzip(sent, 2))

    def reduce(_, rg, rv):
        rg = rg.reshape(-1)
        rv = rv.reshape(-1, m)
        valid = rg >= 0
        g_local = torch.where(valid, torch.div(rg, s, rounding_mode="floor"),
                              gps)
        cols = []
        for j, op in enumerate(ops):
            v = valid.to(rv.dtype) if op == "count" else rv[:, j]
            cols.append(_segment(op, v, g_local, gps + 1)[:gps])
        return torch.stack(cols, dim=1)            # [gps, m]

    out = _fetch(per_shard(reduce, rgs, rvs))      # [s * gps, m]
    gid_range = np.arange(int(n_groups), dtype=np.int64)
    perm = (gid_range % s) * gps + gid_range // s
    return out[perm]


# ----------------------------------------------------- shuffle hash join


class ShuffleJoin:
    """Shuffle (Normal) exchange hash join for non-unique build keys.

    Build once: the build side's key codes are hash-partitioned by
    ``code % s`` and each shard's run is sorted on the host (a one-time
    C-speed lexsort); the sorted code runs live on the mesh as the
    device-resident build state. Probe per block: probe (code, id) rows are
    all_to_all-shuffled to their owner shard, which binary-searches its
    sorted build-code run for the match range ``[lo, lo + count)``
    (reference exchange_transform_shuffle.rs + hash join probe); the host
    expands ranges into (probe_row, build_row) pairs with one np.repeat
    (output materialization is host-side anyway).
    """

    def __init__(self, mesh, build_codes: np.ndarray):
        # codes must be DENSE int32-range factorization codes (negative =
        # NULL), as in the reference
        self.mesh = mesh
        s = mesh.shape[SHARD_AXIS]
        self.s = s
        build_codes = build_codes.astype(np.int32)
        dest = np.where(build_codes >= 0, build_codes % s, -1)
        order = np.lexsort((build_codes, dest))
        order = order[dest[order] >= 0]  # NULL keys never match
        codes_s = build_codes[order]
        dest_s = dest[order]
        counts = np.bincount(dest_s, minlength=s)
        self.build_cap = _next_pow2(max(int(counts.max()), 1))
        # per-shard sorted code runs, padded with int32 max (never matches)
        sentinel = np.iinfo(np.int32).max
        codes_pad = np.full((s, self.build_cap), sentinel, np.int32)
        ids_pad = np.full((s, self.build_cap), -1, np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)])
        for sh in range(s):
            run = slice(offs[sh], offs[sh + 1])
            k = counts[sh]
            codes_pad[sh, :k] = codes_s[run]
            ids_pad[sh, :k] = order[run]
        self.build_ids = ids_pad            # host: for range expansion
        self.build_dev = put_sharded(
            codes_pad.reshape(-1), mesh, P(SHARD_AXIS))

    def probe(self, probe_codes: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (lidx, ridx) pairs sorted by (probe row, build row)."""
        s = self.s
        codes = probe_codes.astype(np.int32)
        ids = np.arange(len(codes), dtype=np.int32)
        padded = pad_rows(codes, s, fill=-1)[0]
        dest = np.where(padded >= 0, padded % s, -1).astype(np.int32)
        capacity = _next_pow2(_shuffle_capacity(dest, s))
        codes_dev, _ = shard_rows_padded(self.mesh, codes, fill=-1)
        ids_dev, _ = shard_rows_padded(self.mesh, ids, fill=-1)
        def send(_, c, i):
            d = torch.where(c >= 0, c % s, s)
            return _shuffle_send(d, [c, i], s, capacity, c >= 0, (-1, -1))

        rcs, ris = (all_to_all(t) for t in unzip(per_shard(
            send, codes_dev.shards(), ids_dev.shards()), 2))

        def search(_, rc, ri, build_sorted):
            rc, ri = rc.reshape(-1), ri.reshape(-1)
            lo = torch.searchsorted(build_sorted, rc)
            hi = torch.searchsorted(build_sorted, rc, right=True)
            return (ri, lo.to(torch.int32),
                    torch.where(ri >= 0, hi - lo, 0).to(torch.int32))

        ri, lo, cnt = (_fetch(t) for t in unzip(per_shard(
            search, rcs, ris, self.build_dev.shards()), 3))
        rows_per_shard = ri.shape[0] // s
        shard_of = np.arange(ri.shape[0]) // rows_per_shard
        hit = cnt > 0
        if not hit.any():
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        h_ids = ri[hit]
        h_lo = lo[hit].astype(np.int64)
        h_cnt = cnt[hit].astype(np.int64)
        h_sh = shard_of[hit]
        # expand [lo, lo+cnt) ranges: repeat + intra-range offsets
        lidx = np.repeat(h_ids, h_cnt).astype(np.int64)
        base = np.repeat(h_lo + h_sh * self.build_cap, h_cnt)
        ends = np.cumsum(h_cnt)
        offsets = np.arange(ends[-1]) - np.repeat(ends - h_cnt, h_cnt)
        ridx = self.build_ids.reshape(-1)[base + offsets]
        order = np.lexsort((ridx, lidx))
        return lidx[order], ridx[order]


# ------------------------------------------- range-partition (sample) sort


def range_partition_sort(mesh, keys: np.ndarray) -> np.ndarray:
    """Distributed full sort (no limit; reference: distributed sort
    fragments at the exchange on sort keys + per-node merge sort): sample
    ~4k keys for splitters, route every row to its key-range shard
    (all_to_all), per-shard device sort (padding rows sink to the tail);
    because shard i's key range precedes shard i+1's, the ordered concat
    across shards IS the total order. ``keys`` must be exact in f32 —
    callers rank-compress arbitrary sort keys first (same contract as
    sharded_topn). Returns row ids (int64) in global ascending-key
    order."""
    s = mesh.shape[SHARD_AXIS]
    n = keys.shape[0]
    k = np.ascontiguousarray(keys, np.float32)
    if n > 4096:
        rng = np.random.default_rng(0)
        sample = k[rng.integers(0, n, 4096)]
    else:
        sample = k
    splitters = np.quantile(sample, np.arange(1, s) / s).astype(np.float32)
    dest = np.searchsorted(splitters, k, side="right").astype(np.int32)
    cols = np.column_stack([k, np.arange(n, dtype=np.float32)])
    capacity = _next_pow2(_shuffle_capacity(pad_rows(dest, s, fill=-1)[0], s))
    dest_dev, _ = shard_rows_padded(mesh, dest, fill=-1)
    vals_dev, _ = shard_rows_padded(mesh, cols.astype(np.float32))
    bufs, valids = _send_rows(dest_dev, vals_dev, s, capacity)

    def local_sort(_, recv, rvalid):
        recv, rvalid = recv.reshape(-1, 2), rvalid.reshape(-1)
        key = torch.where(rvalid, recv[:, 0], float("inf"))
        o = torch.sort(key, stable=True).indices
        return recv[o], rvalid[o]

    recv, valid = (_fetch(t) for t in unzip(per_shard(
        local_sort, all_to_all(bufs), all_to_all(valids)), 2))
    return recv[valid, 1].astype(np.int64)
