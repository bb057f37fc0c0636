"""Table functions: numbers(), fuse_snapshot(), fuse_segment(), fuse_block().

(reference: src/query/service/src/table_functions/ — numbers.rs,
fuse_snapshots, fuse_segments, fuse_blocks)
"""

from __future__ import annotations

import numpy as np

from ..errors import BadArguments, SemanticError
from ..expression import Column, DataBlock, DataField
from ..sql import ast as A
from ..sql.plans import Plan, ValuesPlan
from ..types import Float64, Int64, String, UInt64


def bind_table_function(session, ref: A.TableFunctionRef) -> Plan:
    name = ref.name.lower()
    if name in ("numbers", "numbers_mt", "numbers_local"):
        # _mt/_local are the reference's multi-threaded/local variants of
        # the same generator (identical output)
        return _numbers(ref.args)
    if name in ("fuse_snapshot", "fuse_snapshots"):
        return _fuse_snapshot(session, ref.args)
    if name in ("fuse_segment", "fuse_segments"):
        return _fuse_segment(session, ref.args)
    if name in ("fuse_block", "fuse_blocks"):
        return _fuse_block(session, ref.args)
    if name in ("fuse_virtual_column", "fuse_virtual_columns"):
        return _fuse_virtual_column(session, ref.args)
    if name in ("unnest", "flatten"):
        return _flatten_const(ref.args, name == "unnest")
    if name in ("generate_series", "range"):
        return _generate_series(ref.args, name)
    if name == "result_scan":
        return _result_scan(session, ref.args)
    raise SemanticError(f"unknown table function {ref.name!r}")


def _fuse_virtual_column(session, args) -> Plan:
    """fuse_virtual_column('db','t'): per-block extracted variant paths
    (reference table_functions/fuse_virtual_column.rs)."""
    db, tbl = _const_args(args, 2, "fuse_virtual_column")
    table = _open(session, db, tbl)
    rows = []
    snap = table.read_snapshot()
    if snap is not None:
        for seg in table.read_segments(snap):
            for b in seg.blocks:
                vc = b.virtual_column or {}
                names_ = ", ".join(c["name"] for c in vc.get("columns", []))
                rows.append((b.location, b.row_count,
                             len(vc.get("columns", [])),
                             vc.get("size"), names_ or None))
    names = ["block_location", "row_count", "virtual_column_count",
             "virtual_column_size", "virtual_columns"]
    types = [String, Int64, Int64, Int64.wrap_nullable(),
             String.wrap_nullable()]
    cols = [Column.from_pylist([r[i] for r in rows], t)
            for i, t in enumerate(types)]
    return ValuesPlan(DataBlock(names, cols, len(rows)),
                      [DataField(n, t) for n, t in zip(names, types)])


def _flatten_const(args, unnest: bool) -> Plan:
    """FLATTEN(input => <const>, path/outer/mode/recursive =>) over a
    constant array or JSON text (reference: the FLATTEN srf; the lateral
    correlated form binds in the binder, not here)."""
    from ..expression.evaluator import infer_literal_type
    from ..pipeline.flatten import flatten_value, to_json_or_none
    from ..types import String, UInt64, VariantType
    params = {"path": "", "outer": False, "mode": "both", "recursive": False}
    input_v, is_json = None, True
    for i, a in enumerate(args):
        name, e = (a.name, a.expr) if isinstance(a, A.NamedArg) else (None, a)
        if not isinstance(e, A.Literal):
            raise SemanticError("flatten expects constant arguments"
                                " (use FROM t, LATERAL FLATTEN(..) for"
                                " correlated input)")
        if name in (None, "input"):
            if name is None and i != 0:
                raise BadArguments("flatten takes one positional argument")
            input_v = e.value
            is_json = not isinstance(e.value, (list, tuple))
        elif name in params:
            params[name] = e.value
        else:
            raise BadArguments(f"unknown flatten argument {name}")
    rows = flatten_value(input_v, str(params["path"] or ""),
                         str(params["mode"] or "both"),
                         bool(params["recursive"]), bool(params["outer"]),
                         is_json_text=is_json)
    elem_t = VariantType().wrap_nullable()
    if unnest and not is_json:
        vals = [v for (_, _, _, v, _) in rows]
        elem_t = (infer_literal_type(next(
            (v for v in vals if v is not None), 0))).wrap_nullable()
        value_col = Column.from_pylist(vals, elem_t)
    else:
        value_col = Column.from_pylist(
            [to_json_or_none(v) for (_, _, _, v, _) in rows], elem_t)
    names = ["seq", "key", "path", "index", "value", "this"]
    types = [UInt64, String.wrap_nullable(), String.wrap_nullable(),
             Int64.wrap_nullable(), value_col.dtype,
             VariantType().wrap_nullable()]
    cols = [Column.from_pylist([1] * len(rows), UInt64),
            Column.from_pylist([k for (k, _, _, _, _) in rows], types[1]),
            Column.from_pylist([p for (_, p, _, _, _) in rows], types[2]),
            Column.from_pylist([ix for (_, _, ix, _, _) in rows], types[3]),
            value_col,
            Column.from_pylist([to_json_or_none(t)
                                for (_, _, _, _, t) in rows], types[5])]
    return ValuesPlan(DataBlock(names, cols, len(rows)),
                      [DataField(n, t) for n, t in zip(names, types)])


def _generate_series(args, fname: str) -> Plan:
    """generate_series(start, stop[, step]) — inclusive stop; range() is
    the exclusive-stop alias (reference: generate_series table function)."""
    vals = _const_args(args, len(args), fname)
    if len(vals) not in (2, 3):
        raise BadArguments(f"{fname} expects 2 or 3 arguments")
    start, stop = vals[0], vals[1]
    step = vals[2] if len(vals) == 3 else 1
    if step == 0:
        raise BadArguments(f"{fname} step must not be zero")
    if isinstance(start, float) or isinstance(stop, float) \
            or isinstance(step, float):
        n = max(0, int(np.floor((stop - start) / step)) + 1)
        arr = start + step * np.arange(n, dtype=np.float64)
        if fname == "range" and n and arr[-1] == stop:
            arr = arr[:-1]
        col = Column.from_numpy(arr.astype(np.float64))
        dt = Float64
    else:
        stop_adj = stop + (0 if fname == "range" else (1 if step > 0 else -1))
        arr = np.arange(start, stop_adj, step, dtype=np.int64)
        col = Column.from_numpy(arr)
        dt = Int64
    return ValuesPlan(DataBlock([fname], [col], len(arr)),
                      [DataField(fname, dt)])


def _const_args(args, n, fname):
    out = []
    for a in args:
        if not isinstance(a, A.Literal):
            raise BadArguments(f"{fname} expects constant arguments")
        out.append(a.value)
    if len(out) != n:
        raise BadArguments(f"{fname} expects {n} arguments")
    return out


def _numbers(args) -> Plan:
    (n,) = _const_args(args, 1, "numbers")
    block = DataBlock(["number"], [Column.from_numpy(
        np.arange(int(n), dtype=np.uint64))])
    return ValuesPlan(block, [DataField("number", UInt64)])


def _open(session, db, tbl):
    info = session.catalog.get_table(db, tbl)
    return session.open_table(info)


def _fuse_snapshot(session, args) -> Plan:
    db, tbl = _const_args(args, 2, "fuse_snapshot")
    table = _open(session, db, tbl)
    rows = []
    snap = table.read_snapshot()
    while snap is not None:
        rows.append((snap.snapshot_id, snap.prev_snapshot, len(snap.segments),
                     snap.block_count, snap.row_count, snap.index_size,
                     float(snap.timestamp)))
        if not snap.prev_snapshot:
            break
        try:
            snap = table.read_snapshot(snap.prev_snapshot)
        except Exception:
            snap = None  # history vacuumed past the retention window
    names = ["snapshot_id", "previous_snapshot_id", "segment_count",
             "block_count", "row_count", "vector_index_size", "timestamp"]
    types = [String, String, Int64, Int64, Int64, Int64, Float64]
    cols = [Column.from_pylist([r[i] for r in rows], t.wrap_nullable() if i == 1 else t)
            for i, t in enumerate(types)]
    return ValuesPlan(DataBlock(names, cols, len(rows)),
                      [DataField(n, t) for n, t in zip(names, types)])


def _fuse_segment(session, args) -> Plan:
    db, tbl = _const_args(args, 2, "fuse_segment")
    table = _open(session, db, tbl)
    rows = []
    snap = table.read_snapshot()
    if snap is not None:
        for loc in snap.segments:
            from ..storage.fuse.snapshot import SegmentInfo, read_json
            seg = SegmentInfo.from_dict(read_json(table.abs_path(loc)))
            vsize = sum(v.get("size", 0) for b in seg.blocks
                        for v in b.vector_indexes.values())
            rows.append((loc, len(seg.blocks), seg.row_count, vsize))
    names = ["segment_location", "block_count", "row_count", "vector_index_size"]
    types = [String, Int64, Int64, Int64]
    cols = [Column.from_pylist([r[i] for r in rows], t) for i, t in enumerate(types)]
    return ValuesPlan(DataBlock(names, cols, len(rows)),
                      [DataField(n, t) for n, t in zip(names, types)])


def _fuse_block(session, args) -> Plan:
    db, tbl = _const_args(args, 2, "fuse_block")
    table = _open(session, db, tbl)
    rows = []
    snap = table.read_snapshot()
    if snap is not None:
        for seg in table.read_segments(snap):
            for b in seg.blocks:
                # NULL (not 0) when the block has no vector index — the
                # reference's pre-REFRESH state (09_0000_vector_index_base)
                vsize = sum(v.get("size", 0)
                            for v in b.vector_indexes.values()) \
                    if b.vector_indexes else None
                isize = sum(v.get("size", 0)
                            for v in b.inverted_indexes.values()) \
                    if b.inverted_indexes else None
                rows.append((b.location, b.row_count, b.block_size, vsize, isize))
    names = ["block_location", "row_count", "block_size",
             "vector_index_size", "inverted_index_size"]
    types = [String, Int64, Int64, Int64.wrap_nullable(),
             Int64.wrap_nullable()]
    cols = [Column.from_pylist([r[i] for r in rows], t) for i, t in enumerate(types)]
    return ValuesPlan(DataBlock(names, cols, len(rows)),
                      [DataField(n, t) for n, t in zip(names, types)])


def _result_scan(session, args) -> Plan:
    """result_scan('qid' | last_query_id([-n])) — replay a cached SELECT
    result (reference: the result_scan table function + result cache)."""
    if len(args) != 1:
        raise BadArguments("result_scan expects one argument")
    a = args[0]
    if isinstance(a, A.Literal):
        qid = str(a.value)
    elif isinstance(a, A.FunctionCall) and a.name.lower() == "last_query_id":
        n = -1
        if a.args:
            if not isinstance(a.args[0], A.Literal):
                raise BadArguments("last_query_id expects a constant")
            n = int(a.args[0].value)
        elif getattr(a, "params", None):
            n = int(a.params[0])
        ids = session._last_query_ids
        if not ids or abs(n) > len(ids):
            raise BadArguments("no query result at that offset")
        qid = ids[n if n < 0 else n - 1]
    else:
        raise BadArguments("result_scan expects a query id or"
                           " last_query_id()")
    hit = session._result_scan_cache.get(qid)
    if hit is None:
        raise BadArguments(f"no cached result for query id {qid!r}"
                           " (only the last 8 SELECT results are kept)")
    block, fields = hit
    return ValuesPlan(block, list(fields))
