"""Single-device routing for relational scan->filter->group->agg, on torch.

The reference runs every relational operator inside its N-worker pipeline
executor (src/query/service/src/pipelines/executor/
query_pipeline_executor.rs:62) so a plain ``SELECT ... GROUP BY`` saturates
the machine. The device analog is NOT a thread pool: it is routing the
whole Scan -> Filter -> Aggregate fragment onto the card as one device
program over **device-resident table columns**, so a query dispatch ships
no row data at all — only the [G, n_aggs] result comes back.

Design:

* **Residency beats bandwidth.** Shipping 6M rows per query can never win,
  so columns are uploaded once per (table, snapshot) and cached on the
  device (``CacheManager.device_table_columns`` — the relational sibling of
  the vector corpus cache, reference VectorIndexFileCache caches.rs:57).
  Snapshots are immutable, so the cache needs no invalidation, only LRU
  eviction.

* **Two resident forms per column.**
  - ``codes``: order-preserving dense rank codes (i32) + host-side sorted
    uniques. Grouping, filtering and MIN/MAX run on codes and are therefore
    EXACT for every type (strings and dates included) — the device only
    ever compares small ints; the host maps ranks back to values.
  - ``planes``: fixed-point byte planes (u8 [n, p]) with (scale, bias).
    SUM/AVG run on these via **base-256 limb arithmetic**: every
    arithmetic expression over decimal/integer columns is compiled into a
    list of signed i32 limb arrays with statically tracked magnitude
    bounds; limbs renormalize (carry-split) whenever a bound would
    overflow the i32 accumulator. Per-group masked sums of each limb are
    exact, and the host recombines ``sum = (sum_i 256^i * S_i) / scale``
    in arbitrary-precision Python ints. No f64 emulation on device, no
    f32 rounding in results: the device aggregate is bit-exact (it is
    *more* exact than a host f64 np.sum at >2^53 magnitudes).

* **Three grouping engines**, chosen by the group grid G as the reference
  chooses (its thresholds were set on a TPU and are kept until measured on
  the card): "mask" (G <= ``device_scan_agg_max_groups``) and "matmul"
  (G <= ``device_scan_agg_max_groups_matmul``, no MIN/MAX) both stack
  their count and limb rows into one ``[K, n]`` int32 block and sum it by
  group id in one launch of the hand-written kernel
  ``ops.grouped_sums`` (``csrc/grouped_sums.cu``), where the reference
  builds G masked passes or an int8 one-hot product; "sort" (larger G, up
  to ``device_scan_agg_max_groups_sort``) sorts the rows by group id once
  and takes prefix-sum differences at segment ends. MIN / MAX run on rank
  codes: a per-group ``scatter_reduce_`` on the mask engine, a sort by
  (group, code) on the sort engine.

* **Errors surface.** A plan the route does not cover declines (``_Bail``)
  and a host-side planning error is counted and declines, as in the
  reference; from the first upload on, an error (a kernel that does not
  build or launch, a CUDA fault) propagates to the caller: no host answer
  hides the card.

Reference parity: the routed fragment is the reference's
``AggregatorPartial -> AggregatorFinal`` over a table scan
(src/query/sql/src/executor/physical_plans/physical_aggregate_*.rs),
with filters applied exactly as the host scan does
(pipeline/executor.py::_exec_scan).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import backend
from ..expression import Column, DataBlock
from ..expression.expr import BoundColumn, Constant, Func, ScalarExpr
from ..ops import grouped_sums as gsums

NULL_CODE = -1
# i32 masked-sum accumulator bound: limb_max * chunk_rows must stay below
# 2^31. Limbs renormalize to <=255, so chunks cap at 8M rows.
CHUNK_ROWS = 8_000_000
LIMB_MAX = 255


class _Bail(Exception):
    """Expression/plan shape the device route does not cover."""


# ------------------------------------------------------------ resident forms


class _LazyChunks:
    """Row-chunked device residency with upload-on-first-use: a query
    that compiles forms but then bails (group grid too large) costs no
    host->device transfer."""

    def __init__(self, host_chunks):
        self._host = host_chunks
        self._dev = [None] * len(host_chunks)

    def __len__(self):
        return len(self._host)

    def __getitem__(self, i):
        if self._dev[i] is None:
            self._dev[i] = backend.to_device(self._host[i])
        return self._dev[i]


class DeviceTableColumns:
    """Device-resident forms of one table snapshot's columns (lazy per
    column).

    Chunked along rows at CHUNK_ROWS so i32 limb accumulators never
    overflow and arbitrarily large tables stream through the same program.
    """

    def __init__(self, table, snapshot_id: Optional[str]):
        self.table = table
        self.snapshot_id = snapshot_id
        self.n_rows = 0
        self._sample_ndv: Dict[str, int] = {}
        self.names: List[str] = []
        # name -> {"codes": [dev int32 per chunk], "uniques": np, "has_null",
        #          "planes": [dev uint8 [c,p] per chunk], "scale", "bias",
        #          "nplanes", "valid": [dev bool per chunk] | None}
        self.cols: Dict[str, dict] = {}
        self.nbytes = 0

    # -- host read of one raw column (through the normal scan path)
    def _read_column(self, name: str) -> Column:
        from ..catalog.pushdown import PushDownInfo
        from ..sql.plans import Scan
        from . import executor as ex
        scan = Scan(table=self.table, pushdown=PushDownInfo(projection=[name]),
                    snapshot_id=self.snapshot_id, columns=[name])
        parts = [b.column(name) for b in ex.execute_plan_blocks(scan)]
        if not parts:
            raise _Bail("empty table")
        col = parts[0] if len(parts) == 1 else Column.concat(parts)
        if self.n_rows == 0:
            self.n_rows = len(col)
        return col

    def _chunks(self, arr: np.ndarray):
        return [arr[i:i + CHUNK_ROWS] for i in range(0, len(arr), CHUNK_ROWS)]

    def _put(self, arr: np.ndarray):
        self.nbytes += arr.nbytes
        return _LazyChunks(self._chunks(arr))

    def get(self, name: str, form: str) -> dict:
        """Ensure ``form`` ("codes" or "planes") of column ``name`` is
        resident; returns the column's form dict."""
        ent = self.cols.setdefault(name, {})
        if form in ent:
            return ent
        col = ent.pop("_host", None)
        if col is None:
            col = self._read_column(name)
        if form == "codes":
            self._build_codes(ent, col)
        elif form == "planes":
            self._build_planes(ent, col)
        else:  # pragma: no cover
            raise ValueError(form)
        # keep the host column around only while both forms may be needed
        if not ("codes" in ent and "planes" in ent):
            ent["_host"] = col
        return ent

    def sample_ndv(self, name: str) -> int:
        """Distinct count of the FIRST block only — a cheap upper-bound
        screen before paying a whole-table codes build (a 6M-row column
        read + np.unique costs seconds; a bailing GROUP BY should not
        pay it)."""
        cached = self._sample_ndv.get(name)
        if cached is not None:
            return cached
        from ..storage.fuse import block_io
        snap = self.table.read_snapshot(self.snapshot_id)
        ndv = 0
        if snap is not None:
            done = False
            for seg in self.table.read_segments(snap):
                for bm in seg.blocks:
                    b = block_io.read_block(
                        self.table.abs_path(bm.location),
                        self.table.schema, projection=[name])
                    col = b.column(name)
                    try:
                        vals, valid = self._values_validity(col)
                        sel = vals if valid is None else vals[valid]
                        ndv = len(np.unique(sel))
                    except (TypeError, _Bail):
                        ndv = 1 << 30
                    done = True
                    break
                if done:
                    break
        self._sample_ndv[name] = ndv
        return ndv

    def _values_validity(self, col: Column):
        from ..expression.column import StringData
        data = col.data
        if isinstance(data, StringData):
            vals = data.as_object_array()
        elif isinstance(data, np.ndarray) and data.ndim == 1:
            vals = data
        else:
            raise _Bail("unsupported column layout")
        valid = col.validity
        return vals, valid

    def _build_codes(self, ent: dict, col: Column) -> None:
        vals, valid = self._values_validity(col)
        sel = vals if valid is None else vals[valid]
        try:
            uniques = np.unique(sel)
        except TypeError:
            raise _Bail("un-orderable column values")
        codes = np.searchsorted(uniques, vals).astype(np.int32)
        if valid is not None:
            codes = np.where(valid, codes, np.int32(NULL_CODE))
        ent["codes"] = self._put(codes)
        ent["uniques"] = uniques
        ent["has_null"] = bool(valid is not None and not valid.all())
        ent["dtype"] = col.dtype

    def _build_planes(self, ent: dict, col: Column) -> None:
        vals, valid = self._values_validity(col)
        if not isinstance(vals, np.ndarray) or vals.dtype.kind not in "iufb":
            raise _Bail("non-numeric sum argument")
        v = vals.astype(np.float64, copy=False)
        if valid is not None:
            v = np.where(valid, v, 0.0)
        if vals.dtype.kind in "ib":
            scale = 1
            w = v
        else:
            for scale in (1, 10, 100, 10000):
                w = v * scale
                if np.abs(w).max(initial=0.0) < 2 ** 53 \
                        and np.all(np.abs(w - np.rint(w)) < 1e-6):
                    break
            else:
                raise _Bail("column is not fixed-point")
            w = np.rint(w)
        wi = w.astype(np.int64)
        bias = int(wi.min(initial=0))
        if bias > 0:
            bias = 0
        u = wi - bias  # non-negative
        umax = int(u.max(initial=0))
        nplanes = max(1, (umax.bit_length() + 7) // 8)
        planes = np.empty((len(u), nplanes), np.uint8)
        for i in range(nplanes):
            planes[:, i] = (u >> (8 * i)) & 0xFF
        ent["planes"] = self._put(planes)
        ent["scale"] = scale
        ent["bias"] = bias
        ent["nplanes"] = nplanes
        if valid is not None:
            ent["valid"] = self._put(valid)
        else:
            ent["valid"] = None


def _cache() -> "Any":
    from ..utils.cache import CacheManager, LruCache
    cm = CacheManager.instance()
    if not hasattr(cm, "device_table_columns"):
        cm.device_table_columns = LruCache(
            capacity_bytes=4 << 30, sizeof=lambda v: max(v.nbytes, 1))
    return cm.device_table_columns


def get_table_columns(table, snapshot_id) -> DeviceTableColumns:
    key = (table.info.table_id, snapshot_id)
    return _cache().get_or_load(
        key, lambda: DeviceTableColumns(table, snapshot_id))


# ------------------------------------------------------- expression compiler
#
# Compilation produces a hashable IR; `_build_program` (lru_cached on the
# IR) traces it once per distinct query shape. Value nodes carry exact
# fixed-point semantics: value = (sum_i 256^i * limb_i) / scale, with the
# per-limb |max| tracked statically so renormalization happens exactly
# when an i32 accumulator could overflow.


# predicates/keys whose dictionary exceeds this skip the LUT path (the
# per-query host evaluation over uniques stops being "once, cheap")
MAX_LUT_UNIQUES = 1 << 21

# per-row volatile functions can't be evaluated once-per-distinct-value
_VOLATILE_FNS = {"rand", "random", "uuid", "gen_random_uuid"}


class _Compiler:
    """Lowers bound scalar expressions to the device IR, recording which
    resident forms each referenced column needs. Single-column predicates
    and group keys outside the structured grammar compile via the
    **dictionary LUT trick**: evaluate the expression ONCE over the
    column's host-side uniques (LIKE, regexp, substring, ...), ship the
    tiny per-distinct-value result table, and the device just gathers
    ``lut[codes]`` (VERDICT r4 item 3)."""

    def __init__(self, dtc: DeviceTableColumns):
        self.dtc = dtc
        self.slots: List[Tuple[str, str]] = []  # (col, form) -> env slot
        self.luts: List[np.ndarray] = []        # per-query device uploads
        self._valids: List[tuple] = []          # validity IRs (value_and_valid)

    def _slot(self, name: str, form: str) -> int:
        key = (name, form)
        if key not in self.slots:
            # building the form now also validates eligibility (raises _Bail)
            built = "planes" if form == "planes_valid" else form
            ent = self.dtc.get(name, built)
            if form == "planes_valid" and ent.get("valid") is None:
                raise _Bail("validity slot of a non-nullable column")
            self.slots.append(key)
        return self.slots.index(key)

    def _lut_slot(self, arr: np.ndarray) -> int:
        idx = len(self.luts)
        self.luts.append(arr)
        self.slots.append((f"__lut{idx}", "lut"))
        return len(self.slots) - 1

    # ------------------------------------------------------- LUT helpers
    def _single_column(self, e: ScalarExpr) -> str:
        names = {x.name for x in e.walk() if isinstance(x, BoundColumn)}
        if len(names) != 1:
            raise _Bail("LUT needs exactly one referenced column")
        for x in e.walk():
            if isinstance(x, Func) and x.name in _VOLATILE_FNS:
                raise _Bail("volatile function in LUT expression")
        return names.pop()

    def _uniques_column(self, name: str) -> Column:
        ent = self.dtc.get(name, "codes")
        uniques = ent["uniques"]
        if len(uniques) > MAX_LUT_UNIQUES:
            raise _Bail("LUT dictionary too large")
        dt = ent["dtype"].remove_nullable()
        if uniques.dtype.kind == "O":
            return Column.from_pylist([str(u) for u in uniques], dt)
        return Column(dt, uniques)

    def _eval_over_uniques(self, name: str, e: ScalarExpr) -> Column:
        from ..expression.evaluator import Evaluator
        col = self._uniques_column(name)
        blk = DataBlock([name], [col])
        try:
            return Evaluator(blk).run(e)
        except Exception:
            raise _Bail("expression not host-evaluable over uniques")

    def lut_pred(self, e: ScalarExpr) -> tuple:
        """Arbitrary single-column predicate -> boolean LUT over the
        column's uniques + a device gather. NULL inputs (codes < 0) never
        match, which is WHERE semantics for every non-IS-NULL predicate
        (IS NULL itself compiles structurally before reaching here)."""
        name = self._single_column(e)
        res = self._eval_over_uniques(name, e)
        data = res.data
        if isinstance(data, np.ndarray) and data.dtype == np.bool_:
            arr = data.copy()
        else:
            try:
                arr = np.array([bool(v) for v in res.to_pylist()])
            except TypeError:
                raise _Bail("predicate LUT is not boolean")
        if res.validity is not None:
            arr &= res.validity        # NULL predicate result filters out
        slot = self._slot(name, "codes")
        return ("inlut", self._lut_slot(arr), slot)

    def _const(self, e: ScalarExpr):
        """Fold a column-free subtree to a Python value via the host
        evaluator (to_date('...'), 1 + 2, ...)."""
        if any(isinstance(x, BoundColumn) for x in e.walk()):
            return None
        if isinstance(e, Constant):
            return e.value
        from ..expression.evaluator import Evaluator
        try:
            col = Evaluator(DataBlock([], [], 1)).run(e)
            return col.get(0)
        except Exception:
            raise _Bail("unfoldable constant")

    # ---- value IR: exact fixed-point ("num", scale, node) where node is
    #      ("col", slot, scale, bias, nplanes) | ("const", int_scaled)
    #      | ("lutcol", codes_slot, plane_lut_slot, scale, bias, nplanes,
    #         valid_lut_slot|-1)
    #      | ("add"|"sub", a, b) | ("mul", a, b)
    def value_and_valid(self, e: ScalarExpr):
        """Compile a value expression and the validity IR nodes its SQL
        NULLness depends on (any NULL input -> NULL row, skipped by
        SUM/AVG/COUNT(x))."""
        self._valids: List[tuple] = []
        ir = self.value(e)
        return ir, tuple(sorted(set(self._valids)))

    def lut_value(self, e: ScalarExpr):
        """Single-column numeric expression -> fixed-point planes over the
        column's uniques (u8 [n_uniq, p] LUT); per-row limbs are a device
        gather on the resident codes. Covers AVG(length(url))-style
        computed aggregate args (ClickBench q27/q28) the structured
        planes can't."""
        name = self._single_column(e)
        res = self._eval_over_uniques(name, e)
        vals, valid = self.dtc._values_validity(res)
        if not isinstance(vals, np.ndarray) or vals.dtype.kind not in "iufb":
            raise _Bail("non-numeric LUT value")
        v = vals.astype(np.float64, copy=False)
        if valid is not None:
            v = np.where(valid, v, 0.0)
        if vals.dtype.kind in "ib":
            scale = 1
            w = v
        else:
            for scale in (1, 10, 100, 10000):
                w = v * scale
                if np.abs(w).max(initial=0.0) < 2 ** 53 \
                        and np.all(np.abs(w - np.rint(w)) < 1e-6):
                    break
            else:
                raise _Bail("LUT value is not fixed-point")
            w = np.rint(w)
        wi = w.astype(np.int64)
        bias = min(int(wi.min(initial=0)), 0)
        u = wi - bias
        umax = int(u.max(initial=0))
        nplanes = max(1, (umax.bit_length() + 7) // 8)
        planes = np.empty((len(u), nplanes), np.uint8)
        for i in range(nplanes):
            planes[:, i] = (u >> (8 * i)) & 0xFF
        codes_slot = self._slot(name, "codes")
        plane_slot = self._lut_slot(planes)
        valid_slot = -1
        if valid is not None and not valid.all():
            valid_slot = self._lut_slot(valid.copy())
        ent = self.dtc.cols[name]
        if ent.get("has_null") or valid_slot >= 0:
            self._valids.append(("lutvalid", codes_slot, valid_slot))
        return ("lutcol", codes_slot, plane_slot, scale, bias, nplanes,
                valid_slot)

    def value(self, e: ScalarExpr):
        try:
            return self._value_structured(e)
        except _Bail:
            return self.lut_value(e)

    def _value_structured(self, e: ScalarExpr):
        if not any(isinstance(x, BoundColumn) for x in e.walk()):
            cv = self._const(e)
            if cv is None or isinstance(cv, bool) \
                    or not isinstance(cv, (int, float, np.integer,
                                           np.floating)):
                raise _Bail("non-numeric constant")
            f = float(cv)
            for scale in (1, 10, 100, 10000, 1000000):
                if abs(f * scale - round(f * scale)) < 1e-9:
                    return ("const", int(round(f * scale)), scale)
            raise _Bail("constant is not fixed-point")
        if isinstance(e, BoundColumn):
            slot = self._slot(e.name, "planes")
            ent = self.dtc.cols[e.name]
            if ent.get("valid") is not None:
                self._valids.append(
                    ("slot", self._slot(e.name, "planes_valid")))
            return ("col", slot, ent["scale"], ent["bias"], ent["nplanes"])
        if isinstance(e, Func):
            nm = e.name
            if nm in ("plus", "add") and len(e.args) == 2:
                return ("add", self.value(e.args[0]), self.value(e.args[1]))
            if nm in ("minus", "sub", "subtract") and len(e.args) == 2:
                return ("sub", self.value(e.args[0]), self.value(e.args[1]))
            if nm in ("multiply", "mul") and len(e.args) == 2:
                return ("mul", self.value(e.args[0]), self.value(e.args[1]))
            if nm == "negate" and len(e.args) == 1:
                return ("sub", ("const", 0, 1), self.value(e.args[0]))
            if nm == "divide" and len(e.args) == 2:
                # division by a constant is exact rational arithmetic:
                # (W/s) / (cw/cs) = (W*cs) / (s*cw)
                d = self.value(e.args[1])
                if d[0] != "const" or d[1] == 0:
                    raise _Bail("non-constant or zero divisor")
                cw, cs = d[1], d[2]
                a = self.value(e.args[0])
                if cw < 0:
                    a = ("sub", ("const", 0, 1), a)
                    cw = -cw
                if cs != 1:
                    a = ("mul", a, ("const", cs, 1))
                return ("rescale", a, cw)
        raise _Bail(f"unsupported value expr {e.display()}")


    # ---- predicate IR over codes:
    #      ("cmp", op, slot, code_bound) | ("inlist", slot, codes)
    #      | ("and"|"or", a, b) | ("not", a) | ("isnull", slot, neg)
    #      | ("true",)
    def pred(self, e: Optional[ScalarExpr]):
        if e is None:
            return ("true",)
        try:
            return self._pred_structured(e)
        except _Bail:
            # single-column fallback: LIKE / regexp / IN / arithmetic
            # comparisons — anything the host evaluator can run over the
            # dictionary (AND/OR trees split first, so each conjunct gets
            # its own chance)
            return self.lut_pred(e)

    def _pred_structured(self, e: ScalarExpr):
        if isinstance(e, Func):
            nm = e.name
            if nm in ("and", "logical_and") and len(e.args) == 2:
                return ("and", self.pred(e.args[0]), self.pred(e.args[1]))
            if nm in ("or", "logical_or") and len(e.args) == 2:
                return ("or", self.pred(e.args[0]), self.pred(e.args[1]))
            if nm in ("not", "logical_not") and len(e.args) == 1:
                return ("not", self.pred(e.args[0]))
            if nm in ("is_null", "is_not_null") and len(e.args) == 1 \
                    and isinstance(e.args[0], BoundColumn):
                slot = self._slot(e.args[0].name, "codes")
                return ("isnull", slot, nm == "is_not_null")
            if nm in ("eq", "noteq", "lt", "lte", "gt", "gte") \
                    and len(e.args) == 2:
                a, b = e.args
                if not isinstance(a, BoundColumn) \
                        and isinstance(b, BoundColumn):
                    flip = {"lt": "gt", "lte": "gte", "gt": "lt",
                            "gte": "lte", "eq": "eq", "noteq": "noteq"}
                    a, b, nm = b, a, flip[nm]
                if isinstance(a, BoundColumn):
                    cv = self._const(b)
                    if cv is None:
                        raise _Bail("column-vs-column predicate")
                    return self._cmp_const(nm, a, cv)
        raise _Bail(f"unsupported predicate {e.display() if e else ''}")

    def lut_key(self, e: ScalarExpr):
        """Single-column GROUP BY expression -> (codes_slot, out_size,
        lut_env_slot, null_in_code, out_uniques): the key expression is
        evaluated once over the dictionary, producing an i32 re-coding
        LUT; the device gathers ``lut[codes]`` into the group grid
        (ClickBench q28's REGEXP_REPLACE(...) group key, etc.)."""
        if isinstance(e, BoundColumn):
            vd = getattr(self.dtc, "vdefs", {}).get(e.name)
            if vd is not None:
                # joined dimension attribute: group over the fact BASE
                # slot through the attr lut, so several attributes of
                # one dimension merge into a single tuple entry
                slot = self._slot(vd.base, "codes")
                size = len(vd.uniques)
                lut = np.where(vd.lut < 0, np.int32(size),
                               vd.lut).astype(np.int32)
                return (slot, size, lut, size, vd.uniques)
            slot = self._slot(e.name, "codes")
            ent = self.dtc.cols[e.name]
            size = len(ent["uniques"])
            return (slot, size, None, size, ent["uniques"])
        name = self._single_column(e)
        res = self._eval_over_uniques(name, e)
        vals, valid = self.dtc._values_validity(res)
        sel = vals if valid is None else vals[valid]
        try:
            out_uniques = np.unique(sel)
        except TypeError:
            raise _Bail("un-orderable key expression values")
        # f(NULL): evaluate on a one-row all-NULL block when the input
        # column is nullable (coalesce-style keys map NULL elsewhere)
        ent = self.dtc.cols[name]
        null_maps_to = None
        if ent.get("has_null"):
            from ..expression.evaluator import Evaluator
            dt = ent["dtype"].wrap_nullable()
            ncol = Column.from_pylist([None], dt)
            try:
                nv = Evaluator(DataBlock([name], [ncol])).run(e).get(0)
            except Exception:
                raise _Bail("key expression not evaluable on NULL")
            if nv is not None:
                if isinstance(nv, np.generic):
                    nv = nv.item()
                pos = np.searchsorted(out_uniques, nv)
                if pos >= len(out_uniques) or out_uniques[pos] != nv:
                    out_uniques = np.insert(out_uniques, pos, nv)
                null_maps_to = int(np.searchsorted(out_uniques, nv))
        size = len(out_uniques)
        if valid is not None and size:
            safe = vals.copy()
            safe[~valid] = out_uniques[0]   # garbage under NULL: any value
            lut = np.searchsorted(out_uniques, safe).astype(np.int32)
            lut = np.where(valid, lut, np.int32(size))  # NULL out -> slot
        elif size:
            lut = np.searchsorted(out_uniques, vals).astype(np.int32)
        else:
            lut = np.full(len(vals), np.int32(0))
        slot = self._slot(name, "codes")
        null_in = size if null_maps_to is None else null_maps_to
        return (slot, size, lut, null_in, out_uniques)

    def _cmp_const(self, op: str, col: BoundColumn, cv) -> tuple:
        slot = self._slot(col.name, "codes")
        uniques = self.dtc.cols[col.name]["uniques"]
        try:
            if uniques.dtype.kind == "O":
                cv = str(cv)
                lo = int(np.searchsorted(uniques, cv, side="left"))
                hi = int(np.searchsorted(uniques, cv, side="right"))
            else:
                cvf = float(cv) if uniques.dtype.kind == "f" else cv
                lo = int(np.searchsorted(uniques, cvf, side="left"))
                hi = int(np.searchsorted(uniques, cvf, side="right"))
        except TypeError:
            raise _Bail("incomparable predicate constant")
        # codes are sorted ranks: value < cv  <=>  code < lo, etc.
        if op == "eq":
            if hi == lo:
                return ("false",)
            return ("cmp", "eqcode", slot, lo)
        if op == "noteq":
            if hi == lo:
                return ("notnull_true", slot)
            return ("cmp", "neqcode", slot, lo)
        if op == "lt":
            return ("cmp", "lt", slot, lo)
        if op == "lte":
            return ("cmp", "lt", slot, hi)
        if op == "gt":
            return ("cmp", "gte", slot, hi)
        if op == "gte":
            return ("cmp", "gte", slot, lo)
        raise _Bail(op)


# ------------------------------------------------------------ limb algebra


class _Limbs:
    """Exact fixed-point value on the device: value = sum_i 256^i *
    limbs[i], limbs signed int32 tensors, |limbs[i]| <= maxabs[i] (static
    bound)."""

    __slots__ = ("limbs", "maxabs")

    def __init__(self, limbs, maxabs):
        self.limbs = limbs
        self.maxabs = maxabs


def _limb_renorm(v: _Limbs, bound: int, symbolic: bool = False) -> _Limbs:
    """Carry-split limbs so every |limb| <= LIMB_MAX (when any static
    bound exceeds ``bound``). floor-div carries are exact for signed.
    ``symbolic``: limbs are Python ints (0) — bound tracking only, used
    to derive the static output layout without touching the device."""
    if all(m <= bound for m in v.maxabs):
        return v
    limbs = list(v.limbs)
    maxabs = list(v.maxabs)
    i = 0
    while i < len(limbs):
        if maxabs[i] > bound:
            if symbolic or isinstance(limbs[i], int):
                hi = lo = 0
            else:
                # floor, as jnp.floor_divide: torch's truncating division
                # would leave a negative lo
                hi = torch.div(limbs[i], 256, rounding_mode="floor")
                lo = limbs[i] - hi * 256
            limbs[i] = lo
            maxabs_i = maxabs[i]
            maxabs[i] = LIMB_MAX
            if i + 1 < len(limbs):
                limbs[i + 1] = limbs[i + 1] + hi
                maxabs[i + 1] = maxabs[i + 1] + maxabs_i // 256 + 1
            else:
                limbs.append(hi)
                maxabs.append(maxabs_i // 256 + 1)
        i += 1
    return _Limbs(limbs, maxabs)


def _limb_scale_mul(v: _Limbs, k: int) -> _Limbs:
    if k == 1:
        return v
    out = _Limbs([l * k for l in v.limbs], [m * k for m in v.maxabs])
    return _limb_renorm(out, LIMB_MAX)


def _limb_add(a: _Limbs, b: _Limbs, sub: bool = False) -> _Limbs:
    n = max(len(a.limbs), len(b.limbs))
    limbs, maxabs = [], []
    for i in range(n):
        la = a.limbs[i] if i < len(a.limbs) else None
        lb = b.limbs[i] if i < len(b.limbs) else None
        ma = a.maxabs[i] if i < len(a.limbs) else 0
        mb = b.maxabs[i] if i < len(b.limbs) else 0
        if la is None:
            limbs.append(-lb if sub else lb)
        elif lb is None:
            limbs.append(la)
        else:
            limbs.append(la - lb if sub else la + lb)
        maxabs.append(ma + mb)
    return _limb_renorm(_Limbs(limbs, maxabs), LIMB_MAX)


def _limb_mul(a: _Limbs, b: _Limbs) -> _Limbs:
    # schoolbook convolution; renormalize inputs first so each product
    # term and the per-diagonal accumulation stay within i32
    a = _limb_renorm(a, LIMB_MAX)
    b = _limb_renorm(b, LIMB_MAX)
    na, nb = len(a.limbs), len(b.limbs)
    limbs: List[Any] = [None] * (na + nb - 1)
    maxabs = [0] * (na + nb - 1)
    for i in range(na):
        for j in range(nb):
            t = a.limbs[i] * b.limbs[j]
            m = a.maxabs[i] * b.maxabs[j]
            if limbs[i + j] is None:
                limbs[i + j] = t
            else:
                limbs[i + j] = limbs[i + j] + t
            maxabs[i + j] += m
    return _limb_renorm(_Limbs(limbs, maxabs), LIMB_MAX)


def _align_scales(av, a_scale: int, bv, b_scale: int):
    if a_scale == b_scale:
        return av, bv, a_scale
    if a_scale % b_scale == 0:
        return av, _limb_scale_mul(bv, a_scale // b_scale), a_scale
    if b_scale % a_scale == 0:
        return _limb_scale_mul(av, b_scale // a_scale), bv, b_scale
    s = a_scale * b_scale
    return (_limb_scale_mul(av, b_scale), _limb_scale_mul(bv, a_scale), s)


def _env_device(env) -> torch.device:
    return env[0].device


def _take(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``lut[codes]`` along the first axis; NULL codes (< 0) read entry 0,
    which the caller masks (``jnp.take(lut, jnp.clip(c, 0, None))``)."""
    return torch.index_select(lut, 0, codes.clamp(min=0))


def _eval_value(node, env, n: int, symbolic: bool = False):
    """IR -> (_Limbs, scale) of int32 tensors [n]; with ``symbolic=True``
    limbs are Python ints (0) and only the magnitude bounds are computed —
    used to derive the static output layout."""
    op = node[0]
    if op == "const":
        _, w, scale = node
        limbs, maxabs = [], []
        u = abs(w)
        sign = 1 if w >= 0 else -1
        if u == 0:
            limbs = [0 if symbolic else torch.zeros(
                (n,), dtype=torch.int32, device=_env_device(env))]
            maxabs = [0]
        while u:
            d = u & 0xFF
            limbs.append(0 if symbolic else torch.full(
                (n,), sign * d, dtype=torch.int32, device=_env_device(env)))
            maxabs.append(d)
            u >>= 8
        return _Limbs(limbs, maxabs), scale
    if op == "col":
        _, slot, scale, bias, nplanes = node
        if symbolic:
            limbs = [0] * nplanes
        else:
            planes = env[slot]  # uint8 [n, p]
            limbs = [planes[:, i].to(torch.int32) for i in range(nplanes)]
        maxabs = [LIMB_MAX] * nplanes
        v = _Limbs(limbs, maxabs)
        if bias:
            b, _ = _eval_value(("const", bias, 1), env, n, symbolic)
            v = _limb_add(v, b)
        return v, scale
    if op == "lutcol":
        _, cslot, pslot, scale, bias, nplanes, _vslot = node
        if symbolic:
            limbs = [0] * nplanes
        else:
            # NULL rows read any value: zeroed by validity
            planes = _take(env[pslot], env[cslot])
            limbs = [planes[:, i].to(torch.int32) for i in range(nplanes)]
        maxabs = [LIMB_MAX] * nplanes
        v = _Limbs(limbs, maxabs)
        if bias:
            b, _ = _eval_value(("const", bias, 1), env, n, symbolic)
            v = _limb_add(v, b)
        return v, scale
    if op in ("add", "sub"):
        av, ascale = _eval_value(node[1], env, n, symbolic)
        bv, bscale = _eval_value(node[2], env, n, symbolic)
        av, bv, s = _align_scales(av, ascale, bv, bscale)
        return _limb_add(av, bv, sub=(op == "sub")), s
    if op == "mul":
        av, ascale = _eval_value(node[1], env, n, symbolic)
        bv, bscale = _eval_value(node[2], env, n, symbolic)
        return _limb_mul(av, bv), ascale * bscale
    if op == "rescale":  # exact division by a positive integer constant
        av, ascale = _eval_value(node[1], env, n, symbolic)
        return av, ascale * node[2]
    raise ValueError(op)  # pragma: no cover


def _eval_valid(node, env):
    """Validity IR -> bool [n]: ("slot", env_slot) reads a resident
    validity array; ("lutvalid", codes_slot, lut_slot|-1) derives it from
    NULL codes plus an optional per-unique validity LUT."""
    if node[0] == "slot":
        return env[node[1]]
    _, cslot, lslot = node
    c = env[cslot]
    ok = c >= 0
    if lslot >= 0:
        ok = ok & _take(env[lslot], c)
    return ok


def _eval_pred(node, env, n: int):
    op = node[0]
    if op == "true":
        return torch.ones((n,), dtype=torch.bool, device=_env_device(env))
    if op == "false":
        return torch.zeros((n,), dtype=torch.bool, device=_env_device(env))
    if op == "and":
        return _eval_pred(node[1], env, n) & _eval_pred(node[2], env, n)
    if op == "or":
        return _eval_pred(node[1], env, n) | _eval_pred(node[2], env, n)
    if op == "not":
        # SQL 3-valued NOT over code predicates: code predicates are
        # False on NULL rows either way, which matches WHERE semantics
        # (NULL filters out) for the monotone predicates we compile.
        return ~_eval_pred(node[1], env, n)
    if op == "isnull":
        _, slot, neg = node
        isnull = env[slot] < 0
        return ~isnull if neg else isnull
    if op == "notnull_true":
        return env[node[1]] >= 0
    if op == "inlut":
        _, lslot, cslot = node
        c = env[cslot]
        return (c >= 0) & _take(env[lslot], c)
    if op == "cmp":
        _, kind, slot, bound = node
        c = env[slot]
        notnull = c >= 0
        if kind == "eqcode":
            return c == bound
        if kind == "neqcode":
            return notnull & (c != bound)
        if kind == "lt":
            return notnull & (c < bound)
        if kind == "gte":
            return c >= bound
        raise ValueError(kind)  # pragma: no cover
    raise ValueError(op)  # pragma: no cover


# --------------------------------------------------------------- the program

# the neutral MIN / MAX code of an empty group (reference: 1 << 30)
_BIG = 1 << 30
# int64 sort key (group id, int32 value): the value biased to be unsigned
_LOW_BIAS = 1 << 31
_LOW_MASK = (1 << 32) - 1


def _group_size(group) -> int:
    G = 1
    for _, size, _, _ in group:
        G *= size + 1  # +1 slot per key for NULL
    return G


def _group_ids(group, G: int, env, keep, n: int):
    """int32 [n] grid slot of every row; filtered rows go to the pad group
    G."""
    gid = torch.zeros((n,), dtype=torch.int32, device=keep.device)
    for slot, size, lslot, null_in in group:
        c = env[slot]
        if lslot >= 0:
            c = torch.where(c < 0, null_in, _take(env[lslot], c))
        else:
            c = torch.where(c < 0, size, c)  # NULL -> last slot
        gid = gid * (size + 1) + c
    return torch.where(keep, gid, G)


def _sort_pairs(gid, values):
    """int32 values sorted by (group id, value), as int32:
    ``lax.sort((gid, values), num_keys=2)`` has no torch form, so one sort
    of an int64 key with the group id in the high word."""
    key = (gid.to(torch.int64) << 32) | (values.to(torch.int64) + _LOW_BIAS)
    key = torch.sort(key).values
    return key >> 32, ((key & _LOW_MASK) - _LOW_BIAS).to(torch.int32)


@functools.lru_cache(maxsize=256)
def _build_program(ir: tuple):
    """One device program per distinct (filter, group, aggs) shape.

    ir = (pred_ir, group_tuples, agg_irs, n_env, engine, row_slot) with
    group entries (codes_slot, out_size, lut_env_slot|-1, null_in_code).
    Returns fn(*env_chunk) -> ONE stacked [K, G] int32 tensor, in the
    reference's output layout.

    Three grouping engines:
      - "mask" (small G) and "matmul" (G into the tens of thousands): the
        count, COUNT and SUM/AVG rows (valid count + limbs) go to the
        kernel ``grouped_sums`` as a list of K [n] int32 tensors, read
        where they lie (no [K, n] block); it sums them by group id in one
        launch. The matmul engine keeps the reference's
        rows: every limb split as l = lo + 128*hi with lo in [0, 127]
        (the reference's int8 operands), so the chunk combine and
        ``_finalize`` read both layouts as the reference does. MIN/MAX
        (mask only) are a per-group ``scatter_reduce_`` over rank codes.
      - "sort" (huge G): one stable sort by group id carries a row
        permutation; per-group aggregates are prefix-sum differences at
        the segment ends; MIN/MAX sort (group, code) once more.
    """
    pred_ir, group, agg_irs, n_env, engine, row_slot = ir
    G = _group_size(group)

    def program_sums(*env):
        n = env[row_slot].shape[0]
        keep = _eval_pred(pred_ir, env, n)
        gid = _group_ids(group, G, env, keep, n)
        one = torch.ones((n,), dtype=torch.int32, device=gid.device)
        rows = [one]   # row 0: the group counts, and COUNT(*)
        layout: List[Any] = [0]   # output row: a row of the block, or a

        def add(row):             # finished [G] tensor (MIN/MAX)
            rows.append(row)
            layout.append(len(rows) - 1)

        for a in agg_irs:
            kind = a[0]
            if kind == "count_star":
                layout.append(0)
            elif kind == "count":
                v = one
                for vnode in a[1]:
                    v = v * _eval_valid(vnode, env).to(torch.int32)
                add(v)
            elif kind in ("sum", "avg"):
                _, val_ir, valid_slots = a
                limbs, _ = _eval_value(val_ir, env, n)
                limbs = _limb_renorm(limbs, LIMB_MAX)
                valid = None
                for vnode in valid_slots:
                    vs = _eval_valid(vnode, env)
                    valid = vs if valid is None else (valid & vs)
                if valid is None:
                    layout.append(0)
                else:
                    add(valid.to(torch.int32))
                for l in limbs.limbs:
                    lz = l if valid is None else torch.where(valid, l, 0)
                    if engine == "matmul":
                        hi = torch.div(lz, 128, rounding_mode="floor")
                        add(lz - hi * 128)
                        add(hi)
                    else:
                        add(lz)
            elif kind in ("min", "max"):   # gated off the matmul engine
                c = env[a[1]]
                if kind == "min":
                    src, init, how = torch.where(c < 0, _BIG, c), _BIG, "amin"
                else:
                    src, init, how = c, -_BIG, "amax"
                ext = torch.full((G + 1,), init, dtype=torch.int32,
                                 device=c.device)
                ext.scatter_reduce_(0, gid.to(torch.int64), src, how)
                layout.append(ext[:G])
            else:  # pragma: no cover
                raise ValueError(kind)
        acc = gsums.grouped_sums(gid, rows, G)
        return torch.stack([acc[r, :G] if isinstance(r, int) else r
                            for r in layout])

    if engine in ("mask", "matmul"):
        return program_sums

    def program_sort(*env):
        """Huge-grid grouping WITHOUT scatters or one-hots: ONE sort by
        group id carries a row permutation; per-group aggregates are
        prefix-sum differences at segment boundaries (searchsorted over
        the sorted gids). MIN/MAX ride secondary (gid, code) sorts — the
        first/last element of each segment. Cost is O(n log n),
        independent of G; the [K, G] result transfer is the practical
        ceiling."""
        n = env[row_slot].shape[0]
        keep = _eval_pred(pred_ir, env, n)
        gid = _group_ids(group, G, env, keep, n)
        sg, perm = torch.sort(gid, stable=True)
        starts = torch.searchsorted(
            sg, torch.arange(G + 1, dtype=torch.int32, device=gid.device))
        lo, hi = starts[:-1], starts[1:]
        counts = (hi - lo).to(torch.int32)
        zero = torch.zeros((1,), dtype=torch.int64, device=gid.device)

        def seg_sum(row_i32):
            cs = torch.cat([zero, torch.cumsum(row_i32[perm], 0)])  # int64
            return (cs[hi] - cs[lo]).to(torch.int32)

        outs: List[Any] = [counts]
        one = torch.ones((n,), dtype=torch.int32, device=gid.device)
        for a in agg_irs:
            kind = a[0]
            if kind == "count_star":
                outs.append(counts)
            elif kind == "count":
                v = one
                for vnode in a[1]:
                    v = v * _eval_valid(vnode, env).to(torch.int32)
                outs.append(seg_sum(v))
            elif kind in ("sum", "avg"):
                _, val_ir, valid_slots = a
                limbs, _ = _eval_value(val_ir, env, n)
                limbs = _limb_renorm(limbs, LIMB_MAX)
                valid = None
                for vnode in valid_slots:
                    vs = _eval_valid(vnode, env)
                    valid = vs if valid is None else (valid & vs)
                outs.append(counts if valid is None
                            else seg_sum(valid.to(torch.int32)))
                for l in limbs.limbs:
                    lz = l if valid is None else torch.where(valid, l, 0)
                    outs.append(seg_sum(lz))
            elif kind in ("min", "max"):
                c = env[a[1]]
                # empty segments must yield the neutral element (the
                # gathered boundary row belongs to a NEIGHBOUR segment),
                # or the cross-chunk min/max combine would corrupt
                if kind == "min":
                    _, sc = _sort_pairs(gid, torch.where(c < 0, _BIG, c))
                    # trailing empty segments start at n: jnp.take clips
                    # there, a CUDA gather would fault
                    first = sc[lo.clamp(max=n - 1)]
                    outs.append(torch.where(counts > 0, first, _BIG))
                else:
                    _, sc = _sort_pairs(gid, torch.where(c < 0, -_BIG, c))
                    last = sc[(hi - 1).clamp(min=0)]
                    outs.append(torch.where(counts > 0, last, -_BIG))
            else:  # pragma: no cover
                raise ValueError(kind)
        return torch.stack(outs)

    if engine == "sort":
        return program_sort
    raise ValueError(engine)  # pragma: no cover


# ------------------------------------------------------- COUNT(DISTINCT)
#
# Exact distinct counts are sort-based and CANNOT be combined across row
# chunks (per-chunk distinct sets overlap), so they run as a separate
# two-phase device pipeline over the FULL table: a per-chunk prep program
# computes (gid, value codes) and the finish program concatenates every
# chunk on device, sorts each (gid, code) composite once, counts
# first-occurrence rows per segment, and ships back one [n_distinct, G]
# grid. Reference semantics: aggregate_distinct_state.rs (the group
# hashtable's distinct set), computed here without a single scatter.


@functools.lru_cache(maxsize=256)
def _build_distinct_prep(ir: tuple):
    pred_ir, group, dslots, n_env, row_slot = ir
    G = _group_size(group)

    def prep(*env):
        n = env[row_slot].shape[0]
        keep = _eval_pred(pred_ir, env, n)
        gid = _group_ids(group, G, env, keep, n)
        return (gid,) + tuple(env[s] for s in dslots)

    return prep


@functools.lru_cache(maxsize=256)
def _build_distinct_finish(G: int, n_parts: int, n_distinct: int):

    def finish(*parts):
        gid = torch.cat(parts[:n_parts]) if n_parts > 1 else parts[0]
        bounds = torch.arange(G + 1, dtype=torch.int64, device=gid.device)
        zero = torch.zeros((1,), dtype=torch.int64, device=gid.device)
        outs = []
        for di in range(n_distinct):
            seg = parts[(1 + di) * n_parts:(2 + di) * n_parts]
            code = torch.cat(seg) if n_parts > 1 else seg[0]
            sg, sc = _sort_pairs(gid, code)
            first = torch.ones_like(sc, dtype=torch.bool)
            first[1:] = (sg[1:] != sg[:-1]) | (sc[1:] != sc[:-1])
            uniq = first & (sc >= 0)  # NULLs out
            cs = torch.cat([zero, torch.cumsum(uniq, 0)])
            starts = torch.searchsorted(sg, bounds)
            outs.append(cs[starts[1:]] - cs[starts[:-1]])
        return torch.stack(outs).to(torch.int32)

    return finish


# ------------------------------------------------------------------ routing


def _settings():
    from ..utils.current import current_session
    s = current_session()
    if s is None:
        return None
    return s.settings


def _has_filter(plan) -> bool:
    from ..sql.plans import FilterPlan, Scan
    node = plan.child
    if isinstance(node, FilterPlan):
        return True
    return type(node) is Scan and node.pushdown.filters is not None


def _unwrap_scan(plan):
    """Aggregate child -> (Scan, filter_expr) or bail."""
    from ..sql.plans import FilterPlan, Scan
    node = plan.child
    filt = None
    if isinstance(node, FilterPlan):
        filt = node.expr
        node = node.child
    if type(node) is not Scan:
        raise _Bail("child is not a plain scan")
    pd = node.pushdown
    if node.internal_columns or getattr(node, "virtual_columns", None) \
            or pd.vector_index is not None \
            or pd.inverted_index is not None or pd.limit is not None:
        raise _Bail("scan carries index/limit/virtual pushdowns")
    if pd.filters is not None and filt is not None:
        filt = Func("and", [pd.filters, filt], filt.dtype)
    elif pd.filters is not None:
        filt = pd.filters
    return node, filt


def try_device_scan_agg(plan, fusion=None) -> Optional[DataBlock]:
    """Route an eligible Aggregate(Scan) onto the device; None = host.

    With ``fusion`` (device_fusion.Fusion) the caller is a Sort/Filter
    node above the aggregate asking for HAVING/ORDER BY/LIMIT applied
    on-device. Finalize fusion is not ported (``device_fusion``): such a
    request declines, and the aggregate below it is routed on its own.

    A plan the route does not cover, or an error while planning on the
    host, declines to the host; an error from the first upload on
    propagates."""
    st = _settings()
    if st is None:
        return None
    try:
        if not bool(st.get("enable_device_local_execution")):
            return None
        min_rows = int(st.get("device_scan_agg_min_rows"))
        max_groups = int(st.get("device_scan_agg_max_groups"))
    except Exception:
        return None
    if getattr(plan, "agg_index", None):
        return None  # the aggregating-index scan is strictly cheaper
    try:
        scan, filt = _unwrap_scan(plan)
    except _Bail:
        return None
    table = scan.table
    try:
        snap = table.read_snapshot(scan.snapshot_id)
    except Exception:
        return None
    if snap is None or snap.row_count < min_rows:
        return None
    # work screen (measured, benchmarks/hits_ab): a bare single-aggregate
    # scan (COUNT(*) with a cheap filter, one AVG) finishes on the host
    # inside the ~30 ms dispatch RTT even at 1M rows — route only shapes
    # with real per-row work: a filter or grouping AND either several
    # aggregates or a computed aggregate argument
    has_computed = any(ae and not isinstance(ae[0], BoundColumn)
                       for _, _, ae in plan.aggs)
    has_distinct = any(fn.name == "count_distinct"
                       for _, fn, _ in plan.aggs)
    has_shape = bool(plan.keys) or _has_filter(plan)
    if min_rows > 0 and fusion is None and not has_distinct and not (
            has_shape and (len(plan.aggs) >= 2 or has_computed)):
        # fusion shapes skip the screen: a fused HAVING/top-n over a
        # huge grid wins precisely because only k rows leave the device
        return None  # min_rows = 0 forces the route (tests/debug)
    try:
        matmul_max = int(st.get("device_scan_agg_max_groups_matmul"))
    except Exception:
        matmul_max = 65536
    try:
        sort_max = int(st.get("device_scan_agg_max_groups_sort"))
    except Exception:
        sort_max = 1 << 21
    for _, fn, arg_exprs in plan.aggs:
        if fn.name == "count_distinct":
            # exact distinct over rank codes (sort + first-occurrence
            # count); single bound column only
            if len(arg_exprs) != 1 \
                    or not isinstance(arg_exprs[0], BoundColumn):
                return None
            continue
        if getattr(fn, "distinct", False) or getattr(fn, "multi_arg", False):
            return None
        if fn.name not in ("count", "sum", "avg", "min", "max"):
            return None
        if fn.name in ("min", "max") and (
                len(arg_exprs) != 1
                or not isinstance(arg_exprs[0], BoundColumn)):
            return None
    for _, e in plan.keys:
        if isinstance(e, BoundColumn):
            continue
        # expression keys ride the dictionary LUT when they reference
        # exactly one column (_Compiler.lut_key)
        if len({x.name for x in e.walk()
                if isinstance(x, BoundColumn)}) != 1:
            return None

    try:
        run = _prepare(plan, scan, filt, snap, max_groups, matmul_max,
                       sort_max, fusion=fusion)
    except _Bail:
        return None
    except Exception:
        from ..utils.metrics import METRICS
        METRICS.inc("device_scan_agg_errors")
        return None
    # the device half: not under the catch-all, so a kernel that does not
    # build or launch, or a CUDA fault, reaches the caller
    return run()


def _ndv_estimate(scan, dtc: DeviceTableColumns, name: str) -> int:
    """Distinct-count estimate for a base column: ANALYZE stats when
    available, else the first-block sample (a lower bound — the exact
    post-build grid check still applies)."""
    try:
        from ..statistics.table_stats import load_table_stats
        from ..utils.current import current_session
        s = current_session()
        ts = load_table_stats(s, scan.table.info.table_id) \
            if s is not None else None
        cs = ts.columns.get(name) if ts is not None else None
        if cs is not None and cs.ndv:
            return int(cs.ndv)
    except Exception:
        pass
    try:
        return dtc.sample_ndv(name)
    except Exception:
        return 1 << 30


def _freeze(x):
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(i) for i in x)
    return x


def _value_limb_count(node, bound: int = LIMB_MAX) -> int:
    """Static limb count of a value IR — the same algebra as
    ``_eval_value`` run over magnitude bounds only (limbs=None). The
    matmul engine renormalizes to 127 (i8), so its layout may be one
    limb wider."""
    v, _ = _eval_value(node, env=None, n=0, symbolic=True)
    v = _limb_renorm(v, bound, symbolic=True)
    return len(v.maxabs)


def _pred_slot_masks(pred_ir, comp) -> Dict[int, np.ndarray]:
    """Per-slot boolean masks over the slot's dictionary, derived from
    the TOP-LEVEL AND conjuncts of the compiled predicate: a slot code
    failing its mask can never survive the filter, so group entries on
    that slot may drop it from their domain (GROUP BY l_orderkey under
    an in_set of 57 orders has 57 groups, not 1.5M)."""
    masks: Dict[int, np.ndarray] = {}

    def lut_of(lslot):
        name, form = comp.slots[lslot]
        return comp.luts[int(name[5:])]

    def add(slot, m):
        old = masks.get(slot)
        masks[slot] = m if old is None else (old & m)

    def conj(node):
        op = node[0]
        if op == "and":
            conj(node[1])
            conj(node[2])
            return
        if op == "inlut":
            _, lslot, cslot = node
            lut = lut_of(lslot)
            if isinstance(lut, np.ndarray) and lut.dtype == np.bool_:
                add(cslot, lut)
            return
        if op == "cmp":
            _, kind, slot, bound = node
            try:
                name, _ = comp.slots[slot]
                n = len(comp.dtc.cols[name]["uniques"])
            except Exception:
                return
            ar = np.arange(n)
            if kind == "eqcode":
                add(slot, ar == bound)
            elif kind == "neqcode":
                add(slot, ar != bound)
            elif kind == "lt":
                add(slot, ar < bound)
            elif kind == "gte":
                add(slot, ar >= bound)

    conj(pred_ir)
    return masks


def _merge_group_entries(entries, comp, slot_masks=None):
    """Merge group entries that share one codes slot into a single
    tuple-coded entry, restricted to the slot codes that can survive
    the predicate. GROUP BY o_orderkey, o_orderdate, o_totalprice
    where all three are functions of one underlying slot (e.g. joined
    dimension attributes over the fact's fk codes) must not multiply
    the grid: the true grid is the number of DISTINCT SURVIVING TUPLES
    (57 qualifying orders), not the product of per-column domains.
    Each merged entry carries a per-key decode (key_pos, values,
    nullmask) used by _group_key_columns."""
    from collections import OrderedDict
    slot_masks = slot_masks or {}
    by_slot = OrderedDict()
    for ent in entries:
        by_slot.setdefault(ent[0], []).append(ent)
    out = []
    for slot, ents in by_slot.items():
        mask = slot_masks.get(slot)
        # a lone unrestricted entry needs no tuple enumeration; a weak
        # mask on a lone identity entry is not worth re-coding either
        if len(ents) == 1 and (
                mask is None or mask.sum() > 0.5 * len(mask)
                or ents[0][3] != ents[0][1]):  # f(NULL) != NULL: keep
            out.append(ents[0])
            continue
        name, _ = comp.slots[slot]
        n_uniq = len(comp.dtc.cols[name]["uniques"])
        cols = []
        for (_s, size, lut, _n, _d) in ents:
            c = lut if lut is not None \
                else np.arange(n_uniq, dtype=np.int32)
            cols.append(c.astype(np.int64))
        rows = np.stack(cols, axis=1) if cols \
            else np.zeros((n_uniq, 0), np.int64)
        if mask is not None:
            sub = rows[mask]
        else:
            sub = rows
        null_tuple = np.array([e[3] for e in ents], np.int64)
        if len(sub):
            tup, inv_sub = np.unique(sub, axis=0, return_inverse=True)
        else:
            tup = np.zeros((0, len(ents)), np.int64)
            inv_sub = np.zeros(0, np.int64)
        # the slot-NULL tuple gets a stable home inside the tuple list
        pos = np.nonzero((tup == null_tuple).all(axis=1))[0] \
            if len(tup) else np.zeros(0, np.int64)
        if len(pos):
            null_in_m = int(pos[0])
        else:
            null_in_m = len(tup)
            tup = np.concatenate([tup, null_tuple[None]])
        size_m = len(tup)
        lut_m = np.full(n_uniq, np.int32(null_in_m), np.int32)
        if mask is not None:
            lut_m[mask] = inv_sub.astype(np.int32)
        else:
            lut_m[:] = inv_sub.astype(np.int32)
        decode = []
        for k, (_s, size, _lut, _n, dec) in enumerate(ents):
            key_pos, uniques, _ = dec[0]
            codes_k = tup[:, k]
            kmask = codes_k >= size  # that key's NULL marker code
            safe = np.clip(codes_k, 0, max(size - 1, 0))
            if len(uniques):
                vals = uniques[safe]
            else:
                vals = np.zeros(size_m, dtype=object)
                kmask = np.ones(size_m, np.bool_)
            decode.append((key_pos, vals, kmask if kmask.any() else None))
        out.append((slot, size_m, lut_m, null_in_m, decode))
    return out


def _key_base_column(e) -> str:
    if isinstance(e, BoundColumn):
        return e.name
    return next(x.name for x in e.walk() if isinstance(x, BoundColumn))


def _execute(plan, scan, filt, snap, max_groups: int,
             matmul_max: int, sort_max: int, dtc=None,
             extra_pred_luts=(), fusion=None) -> DataBlock:
    """Shared engine driver. ``dtc`` may be a join-enriched column view
    (device_join_agg) instead of the plain per-table cache entry;
    ``extra_pred_luts`` is a list of (base_column, bool_mask_over_uniques)
    conjuncts (e.g. the INNER-join matched mask over fk codes)."""
    return _prepare(plan, scan, filt, snap, max_groups, matmul_max,
                    sort_max, dtc, extra_pred_luts, fusion)()


def _prepare(plan, scan, filt, snap, max_groups: int,
             matmul_max: int, sort_max: int, dtc=None,
             extra_pred_luts=(), fusion=None) -> Callable[[], DataBlock]:
    """The host half of ``_execute``: compile the plan (raises ``_Bail``
    for what the route does not cover) and return its device half, a call
    that uploads, runs the engine per chunk and finalizes."""
    from ..utils.metrics import METRICS

    if fusion is not None:
        raise _Bail("finalize fusion is not ported (device_fusion)")
    if dtc is None:
        dtc = get_table_columns(scan.table, snap.snapshot_id)
    comp = _Compiler(dtc)

    has_minmax = any(fn.name in ("min", "max") for _, fn, _ in plan.aggs)
    # min/max can't ride the one-hot matmul (no sum form) but DO ride the
    # sort engine; the overall cap is whatever the largest engine allows
    grid_cap = max(max_groups, matmul_max, sort_max) if not has_minmax \
        else max(max_groups, sort_max)

    # cheap grid screen BEFORE any codes build: ANALYZE NDV when present,
    # else a first-block distinct sample — a high-cardinality GROUP BY
    # (e.g. group by l_orderkey) must bail in ~ms, not after a whole-
    # table column read + np.unique. NDV of an expression key's base
    # column upper-bounds the expression's (functions only merge values).
    # per base slot: member key sizes + a domain bound; the merged-tuple
    # entry for a slot is bounded by min(product of member domains,
    # slot domain) — for joined dimension attributes the MATCHED fk
    # codes (+1 null tuple) bound the slot domain far tighter than the
    # fk's full dictionary
    vdefs = getattr(dtc, "vdefs", {})
    per_base: Dict[str, list] = {}
    for _, e in plan.keys:
        base = _key_base_column(e)
        vd = vdefs.get(base)
        if vd is not None:
            size = min(len(vd.uniques), int((vd.lut >= 0).sum()))
            dom = int((vd.lut >= 0).sum()) + 1
            base = vd.base
        else:
            ent = dtc.cols.get(base, {})
            if "codes" in ent:
                size = len(ent["uniques"])
            else:
                size = _ndv_estimate(scan, dtc, base)
            dom = size + 1
        info = per_base.setdefault(base, [1, 1 << 62])
        info[0] = min(info[0] * (size + 1), 1 << 62)
        info[1] = min(info[1], dom)
    est_grid = 1
    for prod, dom in per_base.values():
        est_grid *= min(prod, dom + 1)
    if est_grid > grid_cap:
        # the filter may restrict a key's domain (GROUP BY key under an
        # equality/IN/range conjunct) — only discoverable after the
        # predicate compiles; proceed to the exact post-merge G check
        # when the filter references a key base column, else bail before
        # paying any whole-table codes build
        filt_cols = set() if filt is None else \
            {x.name for x in filt.walk() if isinstance(x, BoundColumn)}
        for name in list(filt_cols):
            vd = vdefs.get(name)
            if vd is not None:
                filt_cols.add(vd.base)
        if not (filt_cols & set(per_base.keys())):
            raise _Bail("group grid estimate exceeds the device cap")

    pred_ir = comp.pred(filt)
    for pname, mask in extra_pred_luts:
        node = ("inlut", comp._lut_slot(np.asarray(mask, np.bool_)),
                comp._slot(pname, "codes"))
        pred_ir = ("and", pred_ir, node) if pred_ir != ("true",) else node
    entries = []   # (slot, size, lut np|None, null_in, decode list)
    for kpos, (_, e) in enumerate(plan.keys):
        slot, size, lut, null_in, uniq = comp.lut_key(e)
        entries.append((slot, size, lut, null_in,
                        [(kpos, uniq, None)]))
    entries = _merge_group_entries(entries, comp,
                                   _pred_slot_masks(pred_ir, comp))
    group: List[Tuple[int, int, int, int]] = []
    decodes: List[list] = []
    G = 1
    for slot, size, lut, null_in, decode in entries:
        lslot = comp._lut_slot(lut) if lut is not None else -1
        group.append((slot, size, lslot, null_in))
        decodes.append(decode)
        G *= size + 1
    if G > grid_cap:
        raise _Bail(f"group grid {G} exceeds the device cap")
    if G <= max_groups:
        engine = "mask"
    elif not has_minmax and G <= matmul_max:
        engine = "matmul"
    elif G <= sort_max:
        engine = "sort"
    else:
        raise _Bail(f"group grid {G} exceeds the device cap")

    agg_irs: List[tuple] = []
    distinct_slots: List[int] = []   # codes slots, one per distinct agg
    for _, fn, arg_exprs in plan.aggs:
        if fn.name == "count_distinct":
            slot = comp._slot(arg_exprs[0].name, "codes")
            agg_irs.append(("count_distinct", slot))
            distinct_slots.append(slot)
        elif fn.name == "count" and not arg_exprs:
            agg_irs.append(("count_star",))
        elif fn.name == "count":
            _, valids = comp.value_and_valid(arg_exprs[0])
            agg_irs.append(("count", valids))
        elif fn.name in ("sum", "avg"):
            val_ir, valids = comp.value_and_valid(arg_exprs[0])
            agg_irs.append((fn.name, val_ir, valids))
        else:  # min / max over a bound column
            slot = comp._slot(arg_exprs[0].name, "codes")
            agg_irs.append((fn.name, slot))

    env_forms = list(comp.slots)
    row_slot = next(i for i, (_, form) in enumerate(env_forms)
                    if form != "lut")
    main_irs = tuple(a for a in agg_irs if a[0] != "count_distinct")
    ir = (_freeze(pred_ir), tuple(group), _freeze(main_irs),
          len(env_forms), engine, row_slot)
    prog = _build_program(ir)

    # flat-output combine plan: counts first, then per agg. The matmul
    # engine splits every limb into (lo, hi) i8 rows.
    rows_per_limb = 2 if engine == "matmul" else 1
    combine = ["add"]
    for a in main_irs:
        if a[0] in ("count_star", "count"):
            combine.append("add")
        elif a[0] in ("sum", "avg"):
            combine.append("add")  # valid count
            combine += ["add"] * (_value_limb_count(a[1]) * rows_per_limb)
        elif a[0] == "min":
            combine.append("min")
        else:
            combine.append("max")

    n_chunks = max((dtc.n_rows + CHUNK_ROWS - 1) // CHUNK_ROWS, 1)
    # transfer screen: without finalize fusion the whole [K, G] grid
    # (plus any distinct grids) crosses the host<->device link —
    # at G in the millions that alone loses to the host hash-agg
    try:
        stx = _settings()
        max_pull_mb = float(stx.get("device_scan_agg_max_pull_mb")) \
            if stx is not None else 16.0
    except Exception:
        max_pull_mb = 16.0
    pull = (len(combine) * 4 + len(distinct_slots) * 8) * G * n_chunks
    if max_pull_mb > 0 and pull > max_pull_mb * (1 << 20):
        raise _Bail("grid result transfer exceeds"
                    " device_scan_agg_max_pull_mb")

    def run() -> DataBlock:
        # a dictionary of no values (an all-NULL column) gets one pad
        # entry: every row reads it through a NULL code and is masked, but
        # a gather from an empty tensor faults on CUDA
        lut_dev = [backend.to_device(l if len(l) else np.zeros(
            (1,) + l.shape[1:], l.dtype)) for l in comp.luts]

        def chunk_env(ci: int):
            env = []
            for name, form in env_forms:
                if form == "lut":
                    env.append(lut_dev[int(name[5:])])
                    continue
                ent = dtc.cols[name]
                if form == "codes":
                    env.append(ent["codes"][ci])
                elif form == "planes":
                    env.append(ent["planes"][ci])
                else:  # planes_valid
                    env.append(ent["valid"][ci])
            return env

        acc: Optional[List[np.ndarray]] = None
        for ci in range(n_chunks):
            stacked = backend.to_numpy(prog(*chunk_env(ci))).astype(np.int64)
            outs = list(stacked)
            if len(outs) != len(combine):  # pragma: no cover
                raise RuntimeError("internal: output layout mismatch")
            if acc is None:
                acc = outs
            else:
                for k, kind in enumerate(combine):
                    if kind == "add":
                        acc[k] = acc[k] + outs[k]
                    elif kind == "min":
                        acc[k] = np.minimum(acc[k], outs[k])
                    else:
                        acc[k] = np.maximum(acc[k], outs[k])

        distinct_res: Optional[np.ndarray] = None
        if distinct_slots:
            # two-phase full-table distinct pipeline (per-chunk distinct
            # grids cannot be combined): prep per chunk, one device-side
            # concat + sort + first-occurrence count in finish
            prep = _build_distinct_prep(
                (_freeze(pred_ir), tuple(group), tuple(distinct_slots),
                 len(env_forms), row_slot))
            parts: List[List[Any]] = [[] for _ in
                                      range(1 + len(distinct_slots))]
            for ci in range(n_chunks):
                res = prep(*chunk_env(ci))
                for i, r in enumerate(res):
                    parts[i].append(r)
            finish = _build_distinct_finish(G, n_chunks, len(distinct_slots))
            flat_parts = [p for group_parts in parts for p in group_parts]
            distinct_res = backend.to_numpy(
                finish(*flat_parts)).astype(np.int64)

        METRICS.inc("device_scan_agg_queries")
        plan.__dict__["_device_routed"] = True  # EXPLAIN ANALYZE marker
        return _finalize(plan, dtc, group, decodes, agg_irs, acc,
                         rows_per_limb, distinct_res)

    return run


def _group_key_columns(plan, decodes, group,
                       present: np.ndarray) -> List[Column]:
    """Grid slot ids -> per-key host value columns (vectorized — the
    sort engine can surface millions of groups). ``decodes[i]`` lists
    (key_pos, values, nullmask) for every plan key the i-th grid entry
    encodes (merged entries encode several)."""
    slots = present.astype(np.int64)
    # decompose slot id most-significant entry first (build order)
    sizes = [size + 1 for _, size, _, _ in group]
    codes_per_entry = []
    rem = slots
    for s in reversed(sizes):
        codes_per_entry.append(rem % s)
        rem = rem // s
    codes_per_entry.reverse()
    cols: List[Optional[Column]] = [None] * len(plan.keys)
    for codes, (_, size, _, _), decode in zip(codes_per_entry, group,
                                              decodes):
        null_mask = codes == size  # the entry's own NULL slot
        safe = np.where(null_mask, 0, codes)
        for key_pos, values, vmask in decode:
            kname, kexpr = plan.keys[key_pos]
            dt = kexpr.dtype
            nm = null_mask.copy()
            if vmask is not None:
                nm |= vmask[safe]
            if isinstance(values, np.ndarray) \
                    and values.dtype.kind in "iufb" and len(values):
                vals = values[np.clip(safe, 0, len(values) - 1)]
                validity = None if not nm.any() else ~nm
                cols[key_pos] = Column.from_numpy(
                    vals, dt if validity is None else dt.wrap_nullable(),
                    validity)
                continue
            if len(values):
                taken = values[np.clip(safe, 0, len(values) - 1)].tolist()
            else:
                taken = [None] * len(safe)
            vals = [None if m else
                    (u.item() if isinstance(u, np.generic) else u)
                    for m, u in zip(nm.tolist(), taken)]
            if any(v is None for v in vals):
                dt = dt.wrap_nullable()
            cols[key_pos] = Column.from_pylist(vals, dt)
    return cols


def _finalize(plan, dtc, group, decodes, agg_irs,
              flat: List[np.ndarray], rows_per_limb: int = 1,
              distinct_res: Optional[np.ndarray] = None,
              sliced_slots: Optional[np.ndarray] = None) -> DataBlock:
    counts = flat[0]
    if sliced_slots is not None:
        # fused finalize already selected/ordered the groups on device;
        # flat rows arrive pre-sliced to those slots
        present = sliced_slots

        def P(arr):
            return arr
    elif group:
        present = np.nonzero(counts > 0)[0]

        def P(arr):
            return arr[present]
    else:
        present = np.array([0], np.int64)  # global agg: always one row

        def P(arr):
            return arr[present]
    gcnt = P(counts)
    cols = _group_key_columns(plan, decodes, group, present) \
        if group else []
    names = [n for n, _ in plan.keys] + [n for n, _, _ in plan.aggs]

    k = 1
    di = 0
    n_rows_tbl = max(dtc.n_rows, 1)
    for (aname, fn, arg_exprs), a in zip(plan.aggs, agg_irs):
        rt = fn.return_type()
        inner = rt.remove_nullable()
        if a[0] == "count_distinct":
            vals = P(distinct_res[di])
            di += 1
            cols.append(Column.from_numpy(vals.astype(np.int64), rt))
        elif a[0] in ("count_star", "count"):
            vals = P(flat[k])
            k += 1
            cols.append(Column.from_numpy(vals.astype(np.int64), rt))
        elif a[0] in ("sum", "avg"):
            vcnt = P(flat[k])
            k += 1
            nlimbs = _value_limb_count(a[1])
            # vectorized int64 recombination with an f64 shadow: int64
            # arithmetic is exact mod 2^64, so whenever the TRUE total
            # fits below 2^62 (checked via the float shadow, which has
            # a 2-bit safety margin over its 53-bit mantissa error) the
            # wrapped int64 result IS the true value; only the rare
            # astronomically-large groups re-run in exact object ints
            total = np.zeros(len(present), np.int64)
            ftotal = np.zeros(len(present), np.float64)
            limb_terms = []
            for i in range(nlimbs):
                # matmul engine: limb split as (lo, hi) with l = lo+128*hi
                for sub in ((1,) if rows_per_limb == 1 else (1, 128)):
                    limb = P(flat[k])
                    k += 1
                    w = (1 << (8 * i)) * sub
                    total = total + limb.astype(np.int64) * w
                    ftotal = ftotal + limb.astype(np.float64) * w
                    limb_terms.append((limb, w))
            risky = np.abs(ftotal) >= float(1 << 62)
            if risky.any():
                fits_i64 = False
                obj = total.astype(object)
                for j in np.nonzero(risky)[0]:
                    obj[j] = sum(int(l[j]) * w for l, w in limb_terms)
                total = obj
            else:
                fits_i64 = True
            scale = _value_scale(a[1])
            zero = vcnt == 0
            validity = None if not zero.any() else ~zero
            if a[0] == "avg":
                if fits_i64:
                    out = (total / scale) / np.maximum(vcnt, 1)
                    cols.append(Column.from_numpy(
                        out, rt.wrap_nullable(), validity))
                else:
                    out = [None if c == 0 else (int(t) / scale) / int(c)
                           for t, c in zip(total, vcnt)]
                    cols.append(Column.from_pylist(out, rt.wrap_nullable()))
            elif inner.is_integer() and scale == 1 and fits_i64:
                cols.append(Column.from_numpy(
                    total, rt.wrap_nullable(), validity))
            elif not inner.is_integer() and fits_i64:
                cols.append(Column.from_numpy(
                    total / scale, rt.wrap_nullable(), validity))
            else:
                out = []
                for t, c in zip(total, vcnt):
                    if c == 0:
                        out.append(None)
                    elif inner.is_integer():
                        q, r = divmod(int(t), scale)
                        out.append(q if r == 0
                                   else int(round(int(t) / scale)))
                    else:
                        out.append(int(t) / scale)
                cols.append(Column.from_pylist(out, rt.wrap_nullable()))
        else:  # min / max
            codes = P(flat[k])
            k += 1
            uniques = dtc.cols[arg_exprs[0].name]["uniques"]
            big = 1 << 30
            bad = (gcnt == 0) | (codes >= big) | (codes <= -big) \
                | (codes < 0) | (codes >= len(uniques))
            if isinstance(uniques, np.ndarray) \
                    and uniques.dtype.kind in "iufb" and len(uniques):
                safe = np.where(bad, 0, codes).astype(np.int64)
                vals = uniques[safe]
                validity = None if not bad.any() else ~bad
                cols.append(Column.from_numpy(
                    vals, rt.wrap_nullable(), validity))
            else:
                out = []
                for c, isbad in zip(codes.tolist(), bad.tolist()):
                    if isbad:
                        out.append(None)
                    else:
                        v = uniques[c]
                        out.append(v.item() if isinstance(v, np.generic)
                                   else v)
                cols.append(Column.from_pylist(out, rt.wrap_nullable()))

    n_out = len(present)
    if not group and n_out == 1 and gcnt[0] == 0:
        # global aggregate over zero matching rows: counts 0, sums NULL —
        # matches _exec_global_aggregate semantics
        pass
    return DataBlock(names, cols, n_out)


def _value_scale(node) -> int:
    op = node[0]
    if op == "const":
        return node[2]
    if op == "col":
        return node[2]
    if op == "lutcol":
        return node[3]
    if op in ("add", "sub"):
        a, b = _value_scale(node[1]), _value_scale(node[2])
        if a % b == 0:
            return a
        if b % a == 0:
            return b
        return a * b
    if op == "mul":
        return _value_scale(node[1]) * _value_scale(node[2])
    if op == "rescale":
        return _value_scale(node[1]) * node[2]
    raise ValueError(op)
