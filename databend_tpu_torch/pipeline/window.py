"""Vectorized window-function execution.

The reference implements windows as pipeline transforms with per-partition
frame state machines (reference: src/query/service/src/pipelines/processors/
transforms/window/). Here a window is one vectorized pass: lexsort rows by
(partition keys, order keys), derive partition / peer-group boundaries as
boolean arrays, compute every function with segmented scans (cumsum /
reduceat / accumulate) on the sorted arrays, and inverse-permute back to
input order. Default frame follows the standard: RANGE BETWEEN UNBOUNDED
PRECEDING AND CURRENT ROW when ORDER BY is present (peers included),
the whole partition otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..errors import SemanticError
from ..expression import Column, DataBlock, StringData
from ..expression.evaluator import Evaluator
from ..expression.expr import Constant
from ..sql.plans import WindowItem, WindowPlan


def _key_pair(col: Column, asc: bool, nulls_first: Optional[bool]):
    """(fill-value array, null-rank array or None) for one sort key —
    same NULL convention as the sort operator (NULL largest by default).

    Strings ride the shared rank encoding (executor._comparable_array):
    only the DISTINCT values decode and sort, then one int gather — the
    per-window O(n*len) object-array decode this used to do is gone."""
    from .executor import _comparable_array
    arr = _comparable_array(col)
    if not isinstance(arr, np.ndarray) or arr.dtype.kind == "O":
        arr = np.asarray(col.data.to_pylist() if isinstance(
            col.data, StringData) else arr, dtype=object)
        if col.validity is not None:
            arr = np.where(col.validity, arr, "")
        if not asc:
            uniq, inv = np.unique(arr.astype(str), return_inverse=True)
            arr = -inv.astype(np.int64)
    else:
        if arr.dtype.kind == "b":
            arr = arr.astype(np.int8)
        if not asc:
            arr = -arr.astype(np.float64)
        if col.validity is not None:
            arr = np.where(col.validity, arr, 0)
    if col.validity is not None:
        nf = nulls_first if nulls_first is not None else False
        null_rank = np.where(col.validity, 0, -1 if nf else 1)
        return arr, null_rank
    return arr, None


def _neq_prev(col: Column) -> np.ndarray:
    """Boolean [n]: row differs from previous row (row 0 = True);
    NULLs compare equal to each other. Vectorized: strings compare by
    their block-local factorize codes, numerics element-wise."""
    n = len(col)
    out = np.empty(n, np.bool_)
    if not n:
        return out
    key = None
    if isinstance(col.data, StringData):
        key = col.data.codes()
        if key is None:
            key = col.data.as_object_array()
    elif isinstance(col.data, np.ndarray) and col.data.ndim == 1:
        key = col.data
    if key is None:  # nested layouts: per-row python compare
        vals = col.to_pylist()
        out[0] = True
        prev = vals[0]
        for i in range(1, n):
            out[i] = vals[i] != prev
            prev = vals[i]
        return out
    out[0] = True
    neq = key[1:] != key[:-1]
    if col.validity is not None:
        v = col.validity
        neq = (v[1:] != v[:-1]) | (v[1:] & v[:-1] & neq)
    out[1:] = neq
    return out


def execute_window(plan: WindowPlan, child_blocks):
    """Yields output blocks. Inputs above the spill threshold are
    hash-partitioned to disk on the (shared) PARTITION BY keys and each
    disk partition is windowed independently — window partitions are
    wholly contained in one hash bucket, so results are exact (reference:
    window_partition spill, spillers/inner.rs)."""
    import itertools
    fields = plan.output_fields()
    names = [f.name for f in fields]
    threshold = _spill_threshold()
    part_keys = _shared_partition_keys(plan)
    buffered = []
    total = 0
    it = (b for b in child_blocks if b.num_rows)
    for b in it:
        buffered.append(b)
        total += b.num_rows
        if threshold and part_keys and total > threshold:
            yield from _execute_spilled(plan, itertools.chain(buffered, it),
                                        part_keys, names)
            return
    if not buffered:
        from ..expression.evaluator import constant_column
        yield DataBlock(names, [constant_column(None, f.dtype.wrap_nullable(), 0)
                                for f in fields], 0)
        return
    if getattr(plan, "distributed", False) and part_keys:
        out = _try_distributed_window(plan, buffered, part_keys, names)
        if out is not None:
            yield out
            return
    yield _window_block(plan, DataBlock.concat(buffered), names)


def _try_distributed_window(plan: WindowPlan, blocks, part_keys, names):
    """Partition-hash exchange for window functions (reference: the
    window_partition shuffle — every plan with a window fragments at a
    hash exchange on PARTITION BY, then each node windows its partitions
    locally). Partition keys factorize to dense codes, the shuffle
    exchange routes equal codes to one shard (all_to_all device program),
    and each shard runs the vectorized window pass over exactly the rows
    it owns; outputs inverse-permute back to input order. Exact because
    a window partition is wholly contained in one hash bucket."""
    from ..parallel.exchange import shuffle_by_key
    from ..parallel.mesh import get_default_mesh
    from .keys import composite_group, factorize_column
    mesh = get_default_mesh()
    if mesh is None:
        return None
    merged = DataBlock.concat(blocks)
    n = merged.num_rows
    if n == 0 or n > (1 << 24):
        return None  # row ids must stay f32-exact through the exchange
    ev = Evaluator(merged)
    try:
        key_cols = [ev.run(e) for e in part_keys]
    except Exception:
        return None
    gids, _ = composite_group([factorize_column(c) for c in key_cols])
    # the exchange uploads the rows: from there on an error propagates
    _, vals, shard_of = shuffle_by_key(
        mesh, gids, np.arange(n, dtype=np.float64)[:, None])
    if vals.shape[0] != n:
        return None
    row_ids = vals[:, 0].astype(np.int64)
    parts = []
    perm = []
    for s in np.unique(shard_of):
        idx = row_ids[shard_of == s]
        parts.append(_window_block(plan, merged.take(idx), names))
        perm.append(idx)
    out = DataBlock.concat(parts)
    perm = np.concatenate(perm)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    from ..utils.metrics import METRICS
    METRICS.inc("distributed_window_queries")
    return out.take(inv)


def _window_block(plan: WindowPlan, block: DataBlock, names) -> DataBlock:
    n = block.num_rows
    ev = Evaluator(block)
    out_cols = [block.column(f.name) for f in plan.child.output_fields()]
    for item in plan.items:
        out_cols.append(_compute_item(ev, item, n))
    return DataBlock(names, out_cols, n)


def _spill_threshold():
    from ..utils.current import current_session
    s = current_session()
    if s is None:
        return None
    try:
        v = int(s.settings.get("window_spill_row_threshold"))
        return v or None
    except Exception:
        return None


def _shared_partition_keys(plan: WindowPlan):
    """The common PARTITION BY exprs across all window items, or None
    (spill needs one partitioning that contains every item's groups)."""
    keys = None
    for item in plan.items:
        if not item.partition_by:
            return None  # unpartitioned window needs the whole input
        sig = [e.display() for e in item.partition_by]
        if keys is None:
            keys = (sig, item.partition_by)
        elif keys[0] != sig:
            return None
    return keys[1] if keys else None


def _execute_spilled(plan: WindowPlan, blocks_iter, part_keys, names):
    from ..utils.metrics import METRICS
    from .executor import N_SPILL_PARTITIONS, _PartitionSpill, _partition_ids
    METRICS.inc("window_spill_queries")
    spill = _PartitionSpill(plan.child.output_fields(), "dbtpu_winspill_")
    try:
        for b in blocks_iter:
            ev = Evaluator(b)
            keys = [ev.run(e) for e in part_keys]
            spill.add_block(b, _partition_ids(keys, b.num_rows))
        for p in range(N_SPILL_PARTITIONS):
            part_blocks = spill.read(p)
            if part_blocks:
                yield _window_block(plan, DataBlock.concat(part_blocks),
                                    names)
    finally:
        spill.cleanup()


def _compute_item(ev: Evaluator, item: WindowItem, n: int) -> Column:
    # ---- sort permutation: partition keys primary, then order keys
    lex_keys: List[np.ndarray] = []
    order_cols = [(ev.run(e), asc, nf) for e, asc, nf in item.order_by]
    part_cols = [ev.run(e) for e in item.partition_by]
    for col, asc, nf in reversed(order_cols):
        arr, null_rank = _key_pair(col, asc, nf)
        lex_keys.append(arr)
        if null_rank is not None:
            lex_keys.append(null_rank)
    for col in reversed(part_cols):
        arr, null_rank = _key_pair(col, True, None)
        lex_keys.append(arr)
        if null_rank is not None:
            lex_keys.append(null_rank)
    perm = np.lexsort(lex_keys) if lex_keys else np.arange(n)

    # ---- boundaries on the sorted domain
    new_part = np.zeros(n, np.bool_)
    new_part[0] = True
    for col in part_cols:
        new_part |= _neq_prev(col.take(perm))
    new_peer = new_part.copy()
    for col, _, _ in order_cols:
        new_peer |= _neq_prev(col.take(perm))
    if not item.order_by:
        # no ORDER BY: the frame is the whole partition; all rows are peers
        new_peer = new_part.copy()

    starts = np.flatnonzero(new_part)
    counts = np.diff(np.append(starts, n))
    part_start = np.repeat(starts, counts)            # [n] first row of my partition
    part_count = np.repeat(counts, counts)            # [n]
    pos = np.arange(n) - part_start                   # [n] 0-based row in partition

    pstarts = np.flatnonzero(new_peer)
    pcounts = np.diff(np.append(pstarts, n))
    peer_start = np.repeat(pstarts, pcounts)
    peer_end = np.repeat(np.append(pstarts[1:], n) - 1, pcounts)
    if not item.order_by:
        peer_end = part_start + part_count - 1        # whole partition

    name = item.func
    sorted_out: Optional[Column] = None

    if name == "row_number":
        vals = (pos + 1).astype(np.int64)
        sorted_out = Column.from_numpy(vals)
    elif name == "rank":
        sorted_out = Column.from_numpy((peer_start - part_start + 1).astype(np.int64))
    elif name == "dense_rank":
        cp = np.cumsum(new_peer.astype(np.int64))
        sorted_out = Column.from_numpy(cp - cp[part_start] + 1)
    elif name == "percent_rank":
        rank = (peer_start - part_start).astype(np.float64)
        denom = np.maximum(part_count - 1, 1).astype(np.float64)
        sorted_out = Column.from_numpy(np.where(part_count > 1, rank / denom, 0.0))
    elif name == "cume_dist":
        sorted_out = Column.from_numpy(
            (peer_end - part_start + 1).astype(np.float64) / part_count)
    elif name == "ntile":
        t = _const_int_arg(item, 0, "ntile")
        q, r = part_count // t, part_count % t
        qq = np.maximum(q, 1)
        cut = r * (q + 1)
        bucket = np.where(pos < cut, pos // np.maximum(q + 1, 1),
                          r + (pos - cut) // qq)
        sorted_out = Column.from_numpy((np.minimum(bucket, t - 1) + 1).astype(np.int64))
    elif name in ("lag", "lead"):
        src = ev.run(item.args[0]).take(perm)
        off = _const_int_arg(item, 1, name, default=1)
        default = None
        if len(item.args) > 2:
            if not isinstance(item.args[2], Constant):
                raise SemanticError(f"{name}() default must be a constant")
            default = item.args[2].value
        vals = src.to_pylist()
        out_vals = []
        if name == "lag":
            ok = pos >= off
            idx = np.arange(n) - off
        else:
            ok = pos + off < part_count
            idx = np.arange(n) + off
        idx = np.clip(idx, 0, n - 1)
        for i in range(n):
            out_vals.append(vals[idx[i]] if ok[i] else default)
        sorted_out = Column.from_pylist(out_vals, item.dtype)
    elif name in ("first_value", "last_value"):
        src = ev.run(item.args[0]).take(perm)
        vals = src.to_pylist()
        at = part_start if name == "first_value" else peer_end
        sorted_out = Column.from_pylist([vals[i] for i in at], item.dtype)
    elif name in ("sum", "avg", "min", "max", "count"):
        sorted_out = _window_aggregate(ev, item, perm, n, starts, part_start,
                                       part_count, peer_end,
                                       order_cols, peer_start)
    else:
        raise SemanticError(f"unsupported window function {name}()")

    # inverse permutation back to input order
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return sorted_out.take(inv)


def _const_int_arg(item: WindowItem, i: int, fname: str, default=None) -> int:
    if len(item.args) <= i:
        if default is not None:
            return default
        raise SemanticError(f"{fname}() missing argument {i}")
    a = item.args[i]
    if not isinstance(a, Constant) or not isinstance(a.value, int):
        raise SemanticError(f"{fname}() argument {i} must be a constant integer")
    return a.value


def _window_aggregate(ev, item: WindowItem, perm, n, starts, part_start,
                      part_count, peer_end, order_cols=None,
                      peer_start=None) -> Column:
    name = item.func
    if item.frame is not None:
        if item.frame_kind == "range":
            lo, hi = _range_frame_bounds(item, perm, n, starts, part_start,
                                         part_count, order_cols,
                                         peer_start, peer_end)
            return _frame_reduce(ev, item, perm, n, lo, hi)
        return _rows_frame_aggregate(ev, item, perm, n, part_start, part_count)
    cumulative = bool(item.order_by)

    if name == "count" and not item.args:
        if cumulative:
            vals = (peer_end - part_start + 1).astype(np.int64)
        else:
            vals = part_count.astype(np.int64)
        return Column.from_numpy(vals)

    src = ev.run(item.args[0]).take(perm)
    if isinstance(src.data, StringData):
        raise SemanticError(f"window {name}() over strings is not supported")
    data = np.asarray(src.data, dtype=np.float64)
    valid = src.validity if src.validity is not None else np.ones(n, np.bool_)
    filled = np.where(valid, data, 0.0)
    vcnt = valid.astype(np.int64)

    if name == "count":
        if cumulative:
            cc = np.cumsum(vcnt)
            base = np.where(part_start > 0, cc[np.maximum(part_start - 1, 0)], 0)
            return Column.from_numpy(cc[peer_end] - base)
        return Column.from_numpy(np.repeat(np.add.reduceat(vcnt, starts),
                                           np.diff(np.append(starts, n))))

    if name in ("sum", "avg"):
        if cumulative:
            cs = np.cumsum(filled)
            cc = np.cumsum(vcnt)
            base_s = np.where(part_start > 0, cs[np.maximum(part_start - 1, 0)], 0.0)
            base_c = np.where(part_start > 0, cc[np.maximum(part_start - 1, 0)], 0)
            s = cs[peer_end] - base_s
            c = cc[peer_end] - base_c
        else:
            reps = np.diff(np.append(starts, n))
            s = np.repeat(np.add.reduceat(filled, starts), reps)
            c = np.repeat(np.add.reduceat(vcnt, starts), reps)
        if name == "sum":
            out = s
        else:
            out = np.divide(s, np.maximum(c, 1))
        validity = c > 0
        return Column.from_numpy(out, item.dtype,
                                 validity if not validity.all() else None)

    # min / max: segmented accumulate (cumulative) or reduceat (whole)
    op = np.minimum if name == "min" else np.maximum
    neutral = np.inf if name == "min" else -np.inf
    work = np.where(valid, data, neutral)
    if cumulative:
        acc = np.empty(n, np.float64)
        ends = np.append(starts[1:], n)
        for s0, e0 in zip(starts, ends):
            acc[s0:e0] = op.accumulate(work[s0:e0])
        cc = np.cumsum(vcnt)
        base_c = np.where(part_start > 0, cc[np.maximum(part_start - 1, 0)], 0)
        c = cc[peer_end] - base_c
        out = acc[peer_end]
    else:
        reps = np.diff(np.append(starts, n))
        red = op.reduceat(work, starts)
        out = np.repeat(red, reps)
        c = np.repeat(np.add.reduceat(vcnt, starts), reps)
    validity = c > 0
    out = np.where(validity, out, 0.0)
    return Column.from_numpy(out, item.dtype,
                             validity if not validity.all() else None)


def _range_frame_bounds(item: WindowItem, perm, n, starts, part_start,
                        part_count, order_cols, peer_start, peer_end):
    """RANGE BETWEEN a AND b: per-row window = rows whose single ORDER BY
    key lies in [key_i + a, key_i + b] within the partition (reference:
    RANGE frames with offsets). Offsets are key-value deltas; rows with a
    NULL ORDER BY key frame over their peer group (NULLs are peers)."""
    if len(item.order_by) != 1:
        raise SemanticError(
            "RANGE frame with offsets requires exactly one ORDER BY key")
    col, asc, _ = order_cols[0]
    if isinstance(col.data, StringData) or not (
            isinstance(col.data, np.ndarray) and col.data.dtype.kind in "iufbmM"):
        raise SemanticError("RANGE frame offsets need a numeric/date ORDER BY key")
    a, b = item.frame
    sorted_col = col.take(perm)
    keys = np.asarray(sorted_col.data, np.float64)
    if not asc:
        # negated keys ascend; PRECEDING still means "toward the frame
        # start", so the offsets keep their signs on the negated axis
        keys = -keys
    valid = (np.ones(n, np.bool_) if sorted_col.validity is None
             else np.asarray(sorted_col.validity))
    lo = np.empty(n, np.int64)
    hi = np.empty(n, np.int64)
    counts = np.diff(np.append(starts, n))
    for s, c in zip(starts.tolist(), counts.tolist()):
        seg = keys[s:s + c]
        segv = valid[s:s + c]
        nv = int(segv.sum())  # non-null rows sort before/after nulls as one run
        # locate the contiguous non-null run inside the partition
        nn_idx = np.flatnonzero(segv)
        if nv:
            nn0, nn1 = nn_idx[0], nn_idx[-1] + 1
            segk = seg[nn0:nn1]
            lo_seg = (np.full(nv, 0) if a is None
                      else np.searchsorted(segk, segk + a, side="left"))
            hi_seg = (np.full(nv, nv - 1) if b is None
                      else np.searchsorted(segk, segk + b, side="right") - 1)
            lo[s + nn0:s + nn1] = s + nn0 + lo_seg
            hi[s + nn0:s + nn1] = s + nn0 + hi_seg
    # NULL-key rows: frame = their peer group
    nulls = ~valid
    if nulls.any():
        lo[nulls] = peer_start[nulls]
        hi[nulls] = peer_end[nulls]
    return lo, hi


def _frame_reduce(ev, item: WindowItem, perm, n, lo, hi) -> Column:
    """Aggregate over per-row [lo, hi] windows (sorted domain): prefix sums
    for sum/avg/count, a sparse-table RMQ for min/max (O(n log n), fully
    vectorized — variable-width windows have no shift trick)."""
    name = item.func
    empty = lo > hi
    if name == "count" and not item.args:
        return Column.from_numpy(np.where(empty, 0, hi - lo + 1).astype(np.int64))
    src = ev.run(item.args[0]).take(perm)
    if isinstance(src.data, StringData):
        raise SemanticError(f"window {name}() over strings is not supported")
    data = np.asarray(src.data, dtype=np.float64)
    valid = src.validity if src.validity is not None else np.ones(n, np.bool_)
    filled = np.where(valid, data, 0.0)
    vcnt = valid.astype(np.int64)
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(hi, 0, n - 1)
    cc = np.concatenate([[0], np.cumsum(vcnt)])
    c = np.where(empty, 0, cc[hi_c + 1] - cc[lo_c])

    if name in ("sum", "avg", "count"):
        cs = np.concatenate([[0.0], np.cumsum(filled)])
        s = np.where(empty, 0.0, cs[hi_c + 1] - cs[lo_c])
        if name == "count":
            return Column.from_numpy(c.astype(np.int64))
        out = s if name == "sum" else np.divide(s, np.maximum(c, 1))
        validity = c > 0
        return Column.from_numpy(out, item.dtype,
                                 validity if not validity.all() else None)

    op = np.minimum if name == "min" else np.maximum
    neutral = np.inf if name == "min" else -np.inf
    work = np.where(valid, data, neutral)
    out = _rmq(work, lo_c, hi_c, op, neutral)
    validity = c > 0
    out = np.where(validity & ~empty, out, 0.0)
    return Column.from_numpy(out, item.dtype,
                             validity if not validity.all() else None)


def _rmq(work, lo, hi, op, neutral):
    """Sparse-table range reduce: answer[i] = op over work[lo[i]..hi[i]]."""
    n = len(work)
    levels = [work]
    j = 1
    while (1 << j) <= n:
        prev = levels[-1]
        half = 1 << (j - 1)
        cur = op(prev[:n - half], prev[half:])
        levels.append(np.concatenate([cur, np.full(half, neutral)]))
        j += 1
    width = np.maximum(hi - lo + 1, 1)
    lg = np.frexp(width.astype(np.float64))[1] - 1  # floor(log2(width))
    out = np.full(n, neutral)
    for j, tbl in enumerate(levels):
        sel = lg == j
        if sel.any():
            span = 1 << j
            out[sel] = op(tbl[lo[sel]], tbl[np.maximum(hi[sel] - span + 1,
                                                       lo[sel])])
    return out


def _rows_frame_aggregate(ev, item: WindowItem, perm, n, part_start,
                          part_count) -> Column:
    """Explicit ROWS BETWEEN a AND b frames: per-row window [i+a, i+b]
    clipped to the partition, computed with prefix sums (sum/count/avg)
    or stacked-shift reductions (min/max)."""
    name = item.func
    a, b = item.frame
    part_end = part_start + part_count - 1
    idx = np.arange(n)
    lo = part_start if a is None else np.maximum(idx + a, part_start)
    hi = part_end if b is None else np.minimum(idx + b, part_end)
    empty = lo > hi

    if name == "count" and not item.args:
        out = np.where(empty, 0, hi - lo + 1).astype(np.int64)
        return Column.from_numpy(out)

    src = ev.run(item.args[0]).take(perm)
    if isinstance(src.data, StringData):
        raise SemanticError(f"window {name}() over strings is not supported")
    data = np.asarray(src.data, dtype=np.float64)
    valid = src.validity if src.validity is not None else np.ones(n, np.bool_)
    filled = np.where(valid, data, 0.0)
    vcnt = valid.astype(np.int64)
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(hi, 0, n - 1)

    if name in ("sum", "avg", "count"):
        cs = np.concatenate([[0.0], np.cumsum(filled)])
        cc = np.concatenate([[0], np.cumsum(vcnt)])
        s = cs[hi_c + 1] - cs[lo_c]
        c = cc[hi_c + 1] - cc[lo_c]
        s = np.where(empty, 0.0, s)
        c = np.where(empty, 0, c)
        if name == "count":
            return Column.from_numpy(c.astype(np.int64))
        out = s if name == "sum" else np.divide(s, np.maximum(c, 1))
        validity = c > 0
        return Column.from_numpy(out, item.dtype,
                                 validity if not validity.all() else None)

    # min/max via shifted stacking when the frame is bounded; otherwise
    # fall back to a per-row loop over partitions (rare: unbounded + frame)
    op = np.minimum if name == "min" else np.maximum
    neutral = np.inf if name == "min" else -np.inf
    work = np.where(valid, data, neutral)
    if a is not None and b is not None:
        acc = np.full(n, neutral)
        for off in range(a, b + 1):
            sh = np.full(n, neutral)
            if off < 0:
                sh[-off:] = work[:n + off] if off != 0 else work
            elif off > 0:
                sh[:n - off] = work[off:]
            else:
                sh = work
            inside = (idx + off >= lo) & (idx + off <= hi)
            acc = op(acc, np.where(inside, sh, neutral))
        out = acc
        cc = np.concatenate([[0], np.cumsum(vcnt)])
        c = np.where(empty, 0, cc[hi_c + 1] - cc[lo_c])
    else:
        out = np.full(n, neutral)
        c = np.zeros(n, np.int64)
        for i in range(n):
            if lo[i] <= hi[i]:
                seg = work[lo[i]:hi[i] + 1]
                out[i] = seg.min() if name == "min" else seg.max()
                c[i] = vcnt[lo[i]:hi[i] + 1].sum()
    validity = c > 0
    out = np.where(validity, out, 0.0)
    return Column.from_numpy(out, item.dtype,
                             validity if not validity.all() else None)
