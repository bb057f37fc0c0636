"""Device-resident rank-code equi-joins feeding the scan-agg engines, on
torch (port of ``databend_tpu/pipeline/device_join_agg.py``).

The reference executes joins with a partitioned hash table inside the
pipeline executor (src/query/service/src/pipelines/processors/transforms/
hash_join/hash_join_build_state.rs:114, hash_join_probe_state.rs). The
TPU-native answer is NOT a device hash table: over HBM-resident rank
codes, a unique-key equi-join is a *dictionary enrichment* — the join
never materializes a row.

Two routes, both reusing device_scan_agg's engines end to end:

* **J1 — join as dictionary enrichment** (star/snowflake aggregates,
  TPC-H q18 family). For ``Agg(... Join(fact, dim) on fact.fk = dim.k)``
  with ``dim.k`` unique over the (filtered) dim rows, every dim
  attribute becomes a *virtual column* of the fact table: a host-built
  i32 LUT mapping each fk rank code -> the attribute's rank code (-1 =
  no match / NULL). Device-side the attribute's codes are one gather
  ``lut[fk_codes]`` — group keys, predicates, MIN/MAX, COUNT(DISTINCT)
  and (via the dictionary value planes) SUM/AVG all ride the existing
  machinery. INNER joins add one boolean matched-LUT predicate; LEFT
  joins need nothing (-1 IS the SQL NULL). Chained/nested dims compose
  LUTs host-side, so the device program for a 3-table star query is the
  same single scan-aggregate program. No row ever crosses the link.

* **J2 — aggregate pushdown through a 1:N join** (TPC-H q13 family).
  ``Agg(keys=[L.k], aggs over R) over L LEFT/INNER JOIN R on L.k=R.fk``
  computes the aggregate over R grouped by fk ON DEVICE (sort engine:
  G = |fk dictionary|), then maps the [G] result onto L's key values on
  the host — unmatched keys get COUNT 0 / NULL sums, duplicate L keys
  scale counts/sums. The join itself is never executed.

Gating mirrors device_scan_agg: the reference's crossover settings, exact
results only, host fallback on any bail. The error policy is
device_scan_agg's: each route's host half (matching the plan, building
the dimension LUTs on the host, compiling the scan-aggregate program)
declines on ``_Bail`` and counts any other error in
``device_join_agg_errors``; the device half it returns (the uploads, the
code gathers, the engine, the fused finalize) runs outside that
catch-all, so a device fault reaches the caller instead of a host answer.
Only ``_VirtualChunks`` and ``_gather_codes`` touch the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import backend
from ..expression import Column, DataBlock
from ..expression.expr import BoundColumn, Func
from . import device_scan_agg as dsa
from .device_scan_agg import _Bail


# --------------------------------------------------------------- virtual defs


@dataclass
class VirtualDef:
    """A joined dimension attribute as a fact-table virtual column:
    ``codes = lut[fact_codes(base)]`` with -1 = unmatched/NULL."""
    base: str                 # REAL fact column the lut indexes by code
    lut: np.ndarray           # i32 [n_base_uniques] -> attr code | -1
    uniques: np.ndarray       # attr dictionary (sorted)
    dtype: Any
    has_null: bool


class _VirtualChunks:
    """Lazy per-chunk device gather lut[base_codes]; cached."""

    def __init__(self, base_chunks, lut: np.ndarray, owner):
        self._base = base_chunks
        self._lut = lut
        self._lut_dev = None
        self._dev: Dict[int, Any] = {}
        self._owner = owner

    def __len__(self):
        return len(self._base)

    def __getitem__(self, ci):
        if ci not in self._dev:
            if self._lut_dev is None:
                # a LUT of no entries gets one pad entry: every code that
                # could read it is a NULL code (< 0), masked by the gather,
                # but a gather from an empty tensor faults on CUDA
                lut = self._lut if len(self._lut) \
                    else np.full(1, -1, np.int32)
                self._lut_dev = backend.to_device(lut)
            arr = _gather_codes(self._lut_dev, self._base[ci])
            self._dev[ci] = arr
            self._owner.nbytes += int(np.prod(arr.shape)) * 4
        return self._dev[ci]


def _gather_codes(lut, c):
    """``lut[c]`` with NULL codes (< 0) kept at -1. Every base code indexes
    the LUT built over the base column's dictionary (``_build_vdefs``)."""
    return torch.where(c < 0, -1, torch.index_select(lut, 0, c.clamp(min=0)))


class _MergedCols:
    """dict-like view: virtual entries first, fact columns otherwise."""

    def __init__(self, joined):
        self._j = joined

    def __getitem__(self, name):
        j = self._j
        if name in j.vdefs:
            return j._virtual_ent(name)
        return j.fact.cols[name]

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def __contains__(self, name):
        return name in self._j.vdefs or name in self._j.fact.cols


class JoinedTableColumns:
    """Fact-table device residency enriched with joined dim attributes."""

    def __init__(self, fact_dtc, vdefs: Dict[str, VirtualDef]):
        self.fact = fact_dtc
        self.vdefs = vdefs
        self.cols = _MergedCols(self)
        self._vents: Dict[str, dict] = {}
        self.nbytes = 0

    @property
    def n_rows(self):
        return self.fact.n_rows

    def _values_validity(self, col):
        return self.fact._values_validity(col)

    def sample_ndv(self, name: str) -> int:
        if name in self.vdefs:
            return len(self.vdefs[name].uniques)
        return self.fact.sample_ndv(name)

    def _virtual_ent(self, name: str) -> dict:
        ent = self._vents.get(name)
        if ent is None:
            vd = self.vdefs[name]
            base_ent = self.fact.get(vd.base, "codes")
            ent = {
                "codes": _VirtualChunks(base_ent["codes"], vd.lut, self),
                "uniques": vd.uniques,
                "has_null": vd.has_null,
                "dtype": vd.dtype,
            }
            self._vents[name] = ent
        return ent

    def get(self, name: str, form: str) -> dict:
        if name in self.vdefs:
            if form != "codes":
                raise _Bail("virtual columns are codes-only"
                            " (values ride dictionary LUT planes)")
            return self._virtual_ent(name)
        return self.fact.get(name, form)


# ----------------------------------------------------------------- the match


@dataclass
class _DimJoin:
    fk: str                 # fact-side key column (may be virtual)
    node: Any               # dim subtree plan
    kind: str               # INNER | LEFT
    dim_key: str            # dim-side key column name
    residual: Optional[Any]  # dim-side-only residual -> dim row filter


def _strip_filters(node):
    from ..sql.plans import FilterPlan
    filts = []
    while isinstance(node, FilterPlan):
        filts.append(node.expr)
        node = node.child
    return node, filts


def _identity_project(node):
    from ..sql.plans import ProjectPlan
    while isinstance(node, ProjectPlan) and all(
            isinstance(e, BoundColumn) and e.name == n
            for n, e in node.items):
        node = node.child
    return node


def _field_names(node) -> set:
    try:
        return {f.name for f in node.output_fields()}
    except Exception:
        return set()


def _refs(expr) -> set:
    return {x.name for x in expr.walk() if isinstance(x, BoundColumn)}


def _estimate_rows(node) -> int:
    from ..sql.plans import FilterPlan, JoinPlan, ProjectPlan, Scan
    if type(node) is Scan:
        try:
            snap = node.table.read_snapshot(node.snapshot_id)
            return int(snap.row_count) if snap is not None else 0
        except Exception:
            return 1 << 40
    if isinstance(node, (FilterPlan, ProjectPlan)):
        return _estimate_rows(node.child)
    if isinstance(node, JoinPlan):
        return max(_estimate_rows(node.left), _estimate_rows(node.right))
    return 1 << 40


def _match_join_tree(agg_child):
    """Aggregate child -> (fact Scan, fact filter expr|None,
    post-join filter exprs, dim joins outer-first) or bail."""
    from ..sql.plans import JoinPlan, Scan

    node, post_filters = _strip_filters(_identity_project(agg_child))
    node = _identity_project(node)
    dims: List[_DimJoin] = []
    while isinstance(node, JoinPlan):
        j = node
        if j.kind not in ("INNER", "LEFT"):
            raise _Bail(f"join kind {j.kind} not device-routable")
        if len(j.left_keys) != 1 or len(j.right_keys) != 1:
            raise _Bail("multi-key equi-join not device-routable")
        lk, rk = j.left_keys[0], j.right_keys[0]
        if not isinstance(lk, BoundColumn) or not isinstance(rk, BoundColumn):
            raise _Bail("non-column join keys")
        lnames = _field_names(j.left)
        rnames = _field_names(j.right)
        resid = j.residual

        def try_side(fact_node, dim_node, fk, dkey, dnames):
            if resid is not None and not (_refs(resid) <= dnames):
                return None
            return fact_node, _DimJoin(fk.name, dim_node, j.kind,
                                       dkey.name, resid)

        # the dim side must have UNIQUE join keys (known only when it is
        # materialized), so pick the side the optimizer sized smaller;
        # LEFT joins preserve the left side, which must stay the fact
        options = [(j.left, j.right, lk, rk, rnames)]
        if j.kind == "INNER":
            options.append((j.right, j.left, rk, lk, lnames))
            if _estimate_rows(j.left) < _estimate_rows(j.right):
                options.reverse()
        pick = None
        for opt in options:
            pick = try_side(*opt)
            if pick is not None:
                break
        if pick is None:
            raise _Bail("residual references both sides")
        node, dj = pick
        dims.append(dj)
        # fact-subtree filters commute with enrichment (they reference
        # only columns that exist below this join), so they are safe to
        # apply as part of the single device predicate
        node, extra = _strip_filters(_identity_project(node))
        post_filters.extend(extra)
        node = _identity_project(node)

    fact_filts: List[Any] = []
    if type(node) is not Scan:
        raise _Bail("fact side is not a plain scan")
    pd = node.pushdown
    if node.internal_columns or getattr(node, "virtual_columns", None) \
            or pd.vector_index is not None \
            or pd.inverted_index is not None or pd.limit is not None:
        raise _Bail("fact scan carries index/limit pushdowns")
    filt = pd.filters
    for f in fact_filts:
        filt = f if filt is None else Func("and", [filt, f], f.dtype)
    return node, filt, post_filters, dims


# --------------------------------------------------------------- dim builds


def _dim_rows(dj: _DimJoin, max_rows: int):
    """Execute the dim subtree host-side -> (columns dict, n_rows).
    Reuses the full engine (nested joins, scan filters, pruning)."""
    from .executor import execute_plan_blocks
    blocks = list(execute_plan_blocks(dj.node))
    blocks = [b for b in blocks if b.num_rows]
    if not blocks:
        names = _field_names(dj.node)
        return {n: None for n in names}, 0
    total = sum(b.num_rows for b in blocks)
    if total > max_rows:
        raise _Bail(f"dim build side {total} rows exceeds"
                    " device_join_build_max_rows")
    out: Dict[str, Column] = {}
    names = blocks[0].names
    for n in names:
        parts = [b.column(n) for b in blocks]
        out[n] = parts[0] if len(parts) == 1 else Column.concat(parts)
    if dj.residual is not None:
        from ..expression.evaluator import Evaluator
        blk = DataBlock(list(out.keys()), list(out.values()), total)
        res = Evaluator(blk).run(dj.residual)
        keep = np.asarray(res.data, bool).copy() \
            if isinstance(res.data, np.ndarray) else \
            np.array([bool(v) for v in res.to_pylist()])
        if res.validity is not None:
            keep &= res.validity
        out = {n: c.take(np.nonzero(keep)[0]) for n, c in out.items()}
        total = int(keep.sum())
    return out, total


def _col_values(col: Column):
    from ..expression.column import StringData
    data = col.data
    if isinstance(data, StringData):
        vals = data.as_object_array()
    elif isinstance(data, np.ndarray) and data.ndim == 1:
        vals = data
    else:
        raise _Bail("unsupported dim column layout")
    return vals, col.validity


def _build_vdefs(dtc, dims: List[_DimJoin], needed: set, max_rows: int
                 ) -> Tuple[Dict[str, VirtualDef], List[Tuple[str, np.ndarray]]]:
    """Resolve dim joins INSIDE-OUT into fact-base LUT virtual columns.
    Returns (vdefs, extra INNER matched-mask predicates)."""
    vdefs: Dict[str, VirtualDef] = {}
    extra_preds: List[Tuple[str, np.ndarray]] = []
    for dj in reversed(dims):
        # fk code space: real fact column or an existing virtual
        vd_fk = vdefs.get(dj.fk)
        if vd_fk is None:
            ent = dtc.fact.get(dj.fk, "codes")
            fk_uniques = ent["uniques"]
            base = dj.fk
            compose = None
        else:
            fk_uniques = vd_fk.uniques
            base = vd_fk.base
            compose = vd_fk.lut
        cols, n_dim = _dim_rows(dj, max_rows)
        if dj.dim_key not in cols:
            raise _Bail("dim key column missing from dim output")
        if n_dim == 0:
            dimrow = np.full(len(fk_uniques), -1, np.int64)
        else:
            dk, dk_valid = _col_values(cols[dj.dim_key])
            rows_idx = np.arange(n_dim)
            if dk_valid is not None:
                rows_idx = rows_idx[dk_valid]
                dk = dk[dk_valid]
            order = np.argsort(dk, kind="stable")
            dk_sorted = dk[order]
            if len(dk_sorted) > 1 and (dk_sorted[1:] == dk_sorted[:-1]).any():
                raise _Bail("dim join key is not unique")
            pos = np.searchsorted(dk_sorted, fk_uniques)
            pos_c = np.clip(pos, 0, max(len(dk_sorted) - 1, 0))
            hit = (pos < len(dk_sorted)) & (dk_sorted[pos_c] == fk_uniques) \
                if len(dk_sorted) else np.zeros(len(fk_uniques), bool)
            dimrow = np.where(hit, rows_idx[order][pos_c], -1)
        matched = dimrow >= 0
        if compose is not None:
            # lift onto the real base: base code -> fk code -> dim row
            m = np.full(len(compose), -1, np.int64)
            ok = compose >= 0
            m[ok] = dimrow[np.clip(compose[ok], 0, None)]
            dimrow, matched = m, m >= 0
        if dj.kind == "INNER":
            extra_preds.append((base, matched.copy()))
        dim_names = set(cols.keys())
        for name in dim_names:
            if name not in needed and name != dj.dim_key:
                continue
            if name in vdefs or name in dtc.fact.cols \
                    or name in getattr(dtc.fact.table.schema,
                                       "field_names", lambda: [])():
                if name != dj.dim_key:
                    raise _Bail(f"ambiguous column name {name!r}")
            col = cols[name]
            if col is None or n_dim == 0:
                vdefs[name] = VirtualDef(
                    base, np.full(len(dimrow), -1, np.int32),
                    np.zeros(0), None, True)
                continue
            vals, valid = _col_values(col)
            mvals = vals[np.clip(dimrow, 0, None)]
            mvalid = matched.copy()
            if valid is not None:
                mvalid &= valid[np.clip(dimrow, 0, None)]
            sel = mvals[mvalid]
            try:
                uniques = np.unique(sel)
            except TypeError:
                raise _Bail("un-orderable dim attribute")
            lut = np.full(len(dimrow), -1, np.int32)
            if len(uniques):
                lut[mvalid] = np.searchsorted(
                    uniques, mvals[mvalid]).astype(np.int32)
            vdefs[name] = VirtualDef(base, lut, uniques, col.dtype,
                                     bool((~mvalid).any()))
    return vdefs, extra_preds


# ------------------------------------------------------------------- J1 route


def _collect_needed(plan, post_filters) -> set:
    need = set()
    for _, e in plan.keys:
        need |= _refs(e)
    for _, _, arg_exprs in plan.aggs:
        for a in arg_exprs:
            need |= _refs(a)
    for f in post_filters:
        need |= _refs(f)
    return need


def _dim_fingerprint(dj: _DimJoin) -> tuple:
    """Stable key for a resolved dim join: plan shape + filter constants
    + every scanned table's snapshot — immutable snapshots make cached
    enrichment LUTs exact across queries (the relational sibling of the
    vector corpus cache)."""
    from ..sql.plans import Scan
    bits: List[str] = [dj.fk, dj.kind, dj.dim_key,
                       dj.residual.display() if dj.residual is not None
                       else ""]

    def walk(p):
        if type(p) is Scan:
            try:
                snap = p.table.read_snapshot(p.snapshot_id)
                sid = getattr(snap, "snapshot_id", None)
            except Exception:
                sid = None
            pdf = p.pushdown.filters
            bits.append(f"scan:{p.table.info.table_id}:{sid}:"
                        f"{pdf.display() if pdf is not None else ''}")
        else:
            bits.append(type(p).__name__)
            e = getattr(p, "expr", None)
            if e is not None:
                bits.append(e.display())
        for c in p.children():
            walk(c)

    walk(dj.node)
    return tuple(bits)


def _route_enrichment(plan, st, min_rows, max_groups, matmul_max,
                      sort_max, fusion=None) -> Callable[[], DataBlock]:
    """The host half of J1: match the join tree, build (or reuse) the
    dimension LUTs and compile the enriched scan-aggregate; returns the
    device half."""
    from ..utils.metrics import METRICS

    scan, filt, post_filters, dims = _match_join_tree(plan.child)
    if not dims:
        raise _Bail("no joins")
    try:
        max_rows = int(st.get("device_join_build_max_rows"))
    except Exception:
        max_rows = 4_000_000
    snap = scan.table.read_snapshot(scan.snapshot_id)
    if snap is None or snap.row_count < min_rows:
        raise _Bail("fact side below device_scan_agg_min_rows")
    fact_dtc = dsa.get_table_columns(scan.table, snap.snapshot_id)
    needed = _collect_needed(plan, post_filters)
    needed |= {d.fk for d in dims}
    cache = fact_dtc.__dict__.setdefault("_join_enrich_cache", {})
    ckey = (tuple(_dim_fingerprint(d) for d in dims),
            tuple(sorted(needed)))
    hit = cache.get(ckey)
    if hit is not None:
        jtc, extra_preds = hit
    else:
        vdefs, extra_preds = _build_vdefs(
            JoinedTableColumns(fact_dtc, {}), dims, needed, max_rows)
        jtc = JoinedTableColumns(fact_dtc, vdefs)
        cache[ckey] = (jtc, extra_preds)
        if len(cache) > 64:
            cache.pop(next(iter(cache)))
    for f in post_filters:
        filt = f if filt is None else Func("and", [filt, f], f.dtype)
    run = dsa._prepare(plan, scan, filt, snap, max_groups, matmul_max,
                       sort_max, dtc=jtc, extra_pred_luts=extra_preds,
                       fusion=fusion)

    def device() -> DataBlock:
        out = run()
        METRICS.inc("device_join_agg_queries")
        return out

    return device


# ------------------------------------------------------------------- J2 route


def _route_agg_pushdown(plan, st, min_rows, max_groups, matmul_max,
                        sort_max) -> Callable[[], DataBlock]:
    """Agg(keys=[L.k], aggs over R / count(*)) over L {LEFT|INNER} JOIN R
    on L.k = R.fk: aggregate R by fk on device, map onto L's keys.

    The host half (this call) matches the plan, compiles the device
    aggregate over R and reads L's keys on the host; it returns the device
    half, which runs the aggregate and maps its groups onto those keys."""
    from ..sql.plans import AggregatePlan, FilterPlan, JoinPlan, Scan
    from .executor import execute_plan_blocks

    node = _identity_project(plan.child)
    if not isinstance(node, JoinPlan) or node.kind not in ("LEFT", "INNER"):
        raise _Bail("not a J2 join shape")
    j = node
    if len(j.left_keys) != 1 or not isinstance(j.left_keys[0], BoundColumn) \
            or not isinstance(j.right_keys[0], BoundColumn):
        raise _Bail("J2 needs single-column keys")
    if len(plan.keys) != 1:
        raise _Bail("J2 needs exactly the left key as group key")
    gk_name, gk_expr = plan.keys[0]
    if not isinstance(gk_expr, BoundColumn) \
            or gk_expr.name != j.left_keys[0].name:
        raise _Bail("group key is not the left join key")
    lnames = _field_names(j.left)
    rnames = _field_names(j.right)
    # residual over the right side only -> right filter
    right = j.right
    if j.residual is not None:
        if not (_refs(j.residual) <= rnames):
            raise _Bail("residual references the left side")
        right = FilterPlan(right, j.residual)
    for _, fn, arg_exprs in plan.aggs:
        for a in arg_exprs:
            if not (_refs(a) <= rnames):
                raise _Bail("aggregate over left columns")
    has_count_star = any(fn.name == "count" and not ae
                         for _, fn, ae in plan.aggs)

    # device aggregate over R grouped by fk (a direct engine call: the
    # whole point is skipping a host hash join)
    synth = AggregatePlan(right, [("__fk", j.right_keys[0])],
                          list(plan.aggs))
    rscan, rfilt = dsa._unwrap_scan(synth)
    rsnap = rscan.table.read_snapshot(rscan.snapshot_id)
    if rsnap is None or rsnap.row_count < min_rows:
        raise _Bail("right side below device_scan_agg_min_rows")
    run = dsa._prepare(synth, rscan, rfilt, rsnap, max_groups,
                       matmul_max, sort_max)

    # host: left keys (+multiplicities)
    lkey = j.left_keys[0].name
    lparts = []
    for b in execute_plan_blocks(j.left):
        if b.num_rows:
            lparts.append(b.column(lkey))
    if not lparts:
        lcol = None
        lvals = np.zeros(0)
        lvalid = None
    else:
        lcol = lparts[0] if len(lparts) == 1 else Column.concat(lparts)
        lvals, lvalid = _col_values(lcol)
    if lvalid is not None:
        null_dup = int((~lvalid).sum())
        lvals = lvals[lvalid]
    else:
        null_dup = 0
    try:
        ukeys, dup = np.unique(lvals, return_counts=True)
    except TypeError:
        raise _Bail("un-orderable left key")
    return lambda: _map_onto_left_keys(plan, j, gk_name, gk_expr, run(),
                                       ukeys, dup, null_dup)


def _map_onto_left_keys(plan, j, gk_name, gk_expr, rblock, ukeys, dup,
                        null_dup) -> DataBlock:
    """J2's host finish: the device groups of R by fk aligned onto L's
    unique keys (unmatched keys get COUNT 0 / NULL sums, duplicate L keys
    scale counts and sums)."""
    from ..utils.metrics import METRICS

    rkeys, rvalid = _col_values(rblock.column("__fk"))
    # align device groups to left keys
    pos = np.searchsorted(ukeys, rkeys) if len(ukeys) else \
        np.zeros(len(rkeys), np.int64)
    pos_c = np.clip(pos, 0, max(len(ukeys) - 1, 0))
    rhit = (pos < len(ukeys)) & (ukeys[pos_c] == rkeys) if len(ukeys) \
        else np.zeros(len(rkeys), bool)
    if rvalid is not None:
        rhit &= rvalid

    n_l = len(ukeys)
    out_names = [gk_name] + [n for n, _, _ in plan.aggs]
    matched_rows = np.full(n_l, -1, np.int64)
    matched_rows[pos_c[rhit]] = np.nonzero(rhit)[0]
    matched = matched_rows >= 0
    safe_rows = np.clip(matched_rows, 0, None)

    # count(*) per fk group on the device result = flat counts; derive
    # from the count column when present, else from any count agg
    cols: List[Column] = []
    kdt = gk_expr.dtype
    if null_dup:
        kcol = Column.from_pylist(
            [None] + [v.item() if isinstance(v, np.generic) else v
                      for v in ukeys], kdt.wrap_nullable())
        pad = 1
    else:
        if isinstance(ukeys, np.ndarray) and ukeys.dtype.kind in "iufb":
            kcol = Column.from_numpy(ukeys, kdt)
        else:
            kcol = Column.from_pylist(
                [v.item() if isinstance(v, np.generic) else v
                 for v in ukeys], kdt)
        pad = 0
    cols.append(kcol)

    for (aname, fn, arg_exprs) in plan.aggs:
        rcol = rblock.column(aname)
        rvals, rv = _col_values(rcol)
        gvals = rvals[safe_rows]
        gvalid = matched.copy()
        if rv is not None:
            gvalid &= rv[safe_rows]
        rt = fn.return_type()
        if fn.name == "count" and not arg_exprs:
            out = np.where(gvalid, gvals, 0).astype(np.int64)
            if j.kind == "LEFT":
                out = np.maximum(out, 1)
            out = out * dup
            head = [null_dup] if pad else []
            cols.append(Column.from_pylist(
                head + out.tolist(), rt))
        elif fn.name in ("count", "count_distinct"):
            out = np.where(gvalid, gvals, 0).astype(np.int64) * dup
            head = [0] if pad else []
            cols.append(Column.from_pylist(head + out.tolist(), rt))
        elif fn.name == "sum":
            out = [None if not ok else
                   (v.item() if isinstance(v, np.generic) else v) * d
                   for ok, v, d in zip(gvalid.tolist(), gvals,
                                       dup.tolist())]
            head = [None] if pad else []
            cols.append(Column.from_pylist(head + out,
                                           rt.wrap_nullable()))
        else:  # avg / min / max: duplicate-invariant
            out = [None if not ok else
                   (v.item() if isinstance(v, np.generic) else v)
                   for ok, v in zip(gvalid.tolist(), gvals)]
            head = [None] if pad else []
            cols.append(Column.from_pylist(head + out,
                                           rt.wrap_nullable()))

    if j.kind == "INNER":
        keep = np.nonzero(matched)[0] + pad
        cols = [c.take(keep) for c in cols]
    METRICS.inc("device_join_agg_queries")
    plan.__dict__["_device_routed"] = True
    return DataBlock(out_names, cols)


# ------------------------------------------------------------------ the hook


def try_device_join_agg(plan, fusion=None) -> Optional[DataBlock]:
    """Route an eligible Aggregate(...Join...) onto the device."""
    st = dsa._settings()
    if st is None:
        return None
    try:
        if not bool(st.get("enable_device_local_execution")):
            return None
        # the scan route's gates, measured on the card (chip_smoke.py
        # --gates): at 300,000 fact rows the routed q3 and q10 beat the
        # host 1.3-1.6x (NVIDIA H100 80GB HBM3, 700.00 W)
        min_rows = int(st.get("device_scan_agg_min_rows"))
        max_groups = int(st.get("device_scan_agg_max_groups"))
    except Exception:
        return None
    if getattr(plan, "agg_index", None):
        return None
    try:
        matmul_max = int(st.get("device_scan_agg_max_groups_matmul"))
    except Exception:
        matmul_max = 16
    try:
        sort_max = int(st.get("device_scan_agg_max_groups_sort"))
    except Exception:
        sort_max = 1 << 22
    for _, fn, arg_exprs in plan.aggs:
        if fn.name == "count_distinct":
            if len(arg_exprs) != 1 \
                    or not isinstance(arg_exprs[0], BoundColumn):
                return None
            continue
        if getattr(fn, "distinct", False) \
                or getattr(fn, "multi_arg", False):
            return None
        if fn.name not in ("count", "sum", "avg", "min", "max"):
            return None
        if fn.name in ("min", "max") and (
                len(arg_exprs) != 1
                or not isinstance(arg_exprs[0], BoundColumn)):
            return None

    # the host halves run under the catch-all; the device half each returns
    # runs outside it, so a device fault reaches the caller
    try:
        run = _route_enrichment(plan, st, min_rows, max_groups,
                                matmul_max, sort_max, fusion=fusion)
    except _Bail:
        run = None
    except Exception:
        from ..utils.metrics import METRICS
        METRICS.inc("device_join_agg_errors")
        return None
    if run is not None:
        return run()
    if fusion is not None:
        # J2 maps device groups onto host-side left keys; the fused
        # HAVING/top-n contract cannot be honored there
        return None
    try:
        run = _route_agg_pushdown(plan, st, min_rows, max_groups,
                                  matmul_max, sort_max)
    except _Bail:
        return None
    except Exception:
        from ..utils.metrics import METRICS
        METRICS.inc("device_join_agg_errors")
        return None
    return run()
