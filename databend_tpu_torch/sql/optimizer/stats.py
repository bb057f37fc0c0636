"""Cardinality estimation for the cost-based optimizer.

Estimates row counts per plan node from (a) exact snapshot row counts,
(b) ANALYZE-produced NDV/histogram statistics when present, (c) textbook
selectivity defaults otherwise. Reference: the cascades cost model
(src/query/sql/src/planner/optimizer/optimizers/cascades/cost/) and
src/common/statistics.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...expression.expr import (BoundColumn, CastExpr, Constant, Func,
                                ScalarExpr)
from ..plans import (AggregatePlan, DistinctPlan, FilterPlan, JoinPlan,
                     LimitPlan, Plan, ProjectPlan, Scan, SortPlan,
                     UnionAllPlan, ValuesPlan, WindowPlan)

DEFAULT_EQ_SELECTIVITY = 0.005
DEFAULT_RANGE_SELECTIVITY = 1.0 / 3.0
DEFAULT_LIKE_SELECTIVITY = 0.1
DEFAULT_OTHER_SELECTIVITY = 0.5


class Estimator:
    """Stateless-ish estimator bound to one session (for ANALYZE stats)."""

    def __init__(self, session):
        self.session = session
        self._table_stats_cache: Dict[int, object] = {}

    # ------------------------------------------------------------- plan rows
    def rows(self, plan: Plan) -> float:
        if isinstance(plan, Scan):
            base = self._scan_base_rows(plan)
            sel = 1.0
            if plan.pushdown.filters is not None:
                sel = self.selectivity(plan.pushdown.filters, plan)
            if plan.pushdown.limit is not None:
                return min(base * sel, float(plan.pushdown.limit))
            return base * sel
        if isinstance(plan, ValuesPlan):
            return float(plan.block.num_rows)
        if isinstance(plan, FilterPlan):
            return self.rows(plan.child) * self.selectivity(plan.expr,
                                                            plan.child)
        if isinstance(plan, (ProjectPlan, WindowPlan, SortPlan)):
            r = self.rows(plan.child)
            if isinstance(plan, SortPlan) and plan.limit is not None:
                return min(r, float(plan.limit))
            return r
        if isinstance(plan, LimitPlan):
            r = self.rows(plan.child)
            return min(r, float(plan.limit)) if plan.limit is not None else r
        if isinstance(plan, AggregatePlan):
            r = self.rows(plan.child)
            if not plan.keys:
                return 1.0
            ndv = 1.0
            for _, e in plan.keys:
                ndv *= self.expr_ndv(e, plan.child, r)
            return max(1.0, min(r, ndv))
        if isinstance(plan, DistinctPlan):
            return max(1.0, self.rows(plan.child) * 0.5)
        if isinstance(plan, UnionAllPlan):
            return sum(self.rows(c) for c in plan.inputs)
        if isinstance(plan, JoinPlan):
            return self.join_rows(plan.kind, self.rows(plan.left),
                                  self.rows(plan.right),
                                  [(lk, rk) for lk, rk in
                                   zip(plan.left_keys, plan.right_keys)],
                                  plan.left, plan.right)
        # unknown node: be conservative
        kids = plan.children()
        return max((self.rows(c) for c in kids), default=1000.0)

    def join_rows(self, kind: str, lrows: float, rrows: float, key_pairs,
                  left_plan: Optional[Plan] = None,
                  right_plan: Optional[Plan] = None) -> float:
        if kind == "CROSS" or not key_pairs:
            return lrows * rrows
        # classic |L||R| / prod(max(ndv_l, ndv_r)) over equi keys
        denom = 1.0
        for lk, rk in key_pairs:
            ndv_l = self.expr_ndv(lk, left_plan, lrows)
            ndv_r = self.expr_ndv(rk, right_plan, rrows)
            denom *= max(ndv_l, ndv_r, 1.0)
        est = lrows * rrows / denom
        if kind in ("LEFT", "FULL"):
            est = max(est, lrows)
        if kind in ("RIGHT", "FULL"):
            est = max(est, rrows)
        return max(est, 1.0)

    # ---------------------------------------------------------------- tables
    def _scan_base_rows(self, scan: Scan) -> float:
        try:
            snap = scan.table.read_snapshot(scan.snapshot_id)
            return float(snap.row_count) if snap is not None else 0.0
        except Exception:
            return 0.0

    def _column_stats(self, scan: Scan, name: str):
        """ANALYZE stats for a base column, scaled if stale."""
        from ...statistics import load_table_stats
        tid = scan.table.info.table_id
        ts = self._table_stats_cache.get(tid, False)
        if ts is False:
            try:
                ts = load_table_stats(self.session, tid)
            except Exception:
                ts = None
            self._table_stats_cache[tid] = ts
        if ts is None:
            return None, 1.0
        cs = ts.columns.get(name)
        if cs is None:
            # join-dedup renames base cols to "alias.name"; try the suffix
            base = name.split(".")[-1]
            cs = ts.columns.get(base)
        cur = self._scan_base_rows(scan)
        scale = (cur / ts.row_count) if ts.row_count else 1.0
        return cs, max(scale, 1e-9)

    # ----------------------------------------------------------- expressions
    def expr_ndv(self, e: ScalarExpr, plan: Optional[Plan],
                 plan_rows: float) -> float:
        """NDV of an expression over a plan's output (column lookups walk
        down to the underlying Scan when the path is transparent)."""
        if isinstance(e, CastExpr):
            return self.expr_ndv(e.arg, plan, plan_rows)
        if isinstance(e, BoundColumn) and plan is not None:
            scan = _resolve_scan(plan, e.name)
            if scan is not None:
                cs, scale = self._column_stats(scan[0], scan[1])
                if cs is not None:
                    return max(1.0, min(cs.ndv * scale, plan_rows))
        # fallback: assume a key-like column (the PK/FK assumption that
        # makes star joins estimate correctly without ANALYZE)
        return max(plan_rows, 1.0)

    def selectivity(self, e: ScalarExpr, plan: Optional[Plan]) -> float:
        if isinstance(e, Constant):
            if e.value in (True, 1):
                return 1.0
            if e.value in (False, 0, None):
                return 0.0
            return DEFAULT_OTHER_SELECTIVITY
        if not isinstance(e, Func):
            return DEFAULT_OTHER_SELECTIVITY
        n = e.name
        if n == "and":
            s = 1.0
            for a in e.args:
                s *= self.selectivity(a, plan)
            return s
        if n == "or":
            s1 = self.selectivity(e.args[0], plan)
            s2 = self.selectivity(e.args[1], plan)
            return min(1.0, s1 + s2 - s1 * s2)
        if n == "not":
            return 1.0 - self.selectivity(e.args[0], plan)
        col, const = _col_const(e)
        if n == "eq":
            if col is not None and plan is not None:
                hit = _resolve_scan(plan, col.name)
                if hit is not None:
                    cs, scale = self._column_stats(hit[0], hit[1])
                    if cs is not None:
                        return 1.0 / max(cs.ndv * scale, 1.0)
            return DEFAULT_EQ_SELECTIVITY
        if n == "noteq":
            return 1.0 - self.selectivity(
                Func("eq", e.args, e.dtype), plan)
        if n in ("lt", "lte", "gt", "gte"):
            frac = self._range_fraction(n, col, const, plan)
            return frac if frac is not None else DEFAULT_RANGE_SELECTIVITY
        if n in ("like", "ilike", "regexp"):
            return DEFAULT_LIKE_SELECTIVITY
        if n in ("is_null",):
            return 0.1
        if n in ("is_not_null",):
            return 0.9
        return DEFAULT_OTHER_SELECTIVITY

    def _range_fraction(self, op: str, col, const, plan) -> Optional[float]:
        if col is None or const is None or plan is None:
            return None
        if not isinstance(const.value, (int, float)) \
                or isinstance(const.value, bool):
            return None
        hit = _resolve_scan(plan, col.name)
        if hit is None:
            return None
        cs, _ = self._column_stats(hit[0], hit[1])
        if cs is None or not cs.bounds:
            return None
        from ...statistics import histogram_range_fraction
        v = float(const.value)
        if op in ("lt", "lte"):
            return histogram_range_fraction(cs, None, v)
        return histogram_range_fraction(cs, v, None)


def _col_const(e: Func):
    """(column, constant) for `col op const` / `const op col`, else Nones."""
    if len(e.args) != 2:
        return None, None
    a, b = e.args
    a = a.arg if isinstance(a, CastExpr) else a
    b = b.arg if isinstance(b, CastExpr) else b
    if isinstance(a, BoundColumn) and isinstance(b, Constant):
        return a, b
    if isinstance(b, BoundColumn) and isinstance(a, Constant):
        return b, a
    return None, None


def _resolve_scan(plan: Plan, name: str):
    """Walk transparent nodes to the Scan producing column ``name``.
    Returns (scan, base_column_name) or None."""
    nl = name.lower()
    if isinstance(plan, Scan):
        try:
            base = nl.split(".")[-1]
            plan.table.schema.field(base)
            return plan, base
        except Exception:
            return None
    if isinstance(plan, (FilterPlan, SortPlan, LimitPlan, DistinctPlan,
                         WindowPlan)):
        return _resolve_scan(plan.child, name)
    if isinstance(plan, ProjectPlan):
        for n, e in plan.items:
            if n.lower() == nl:
                if isinstance(e, BoundColumn):
                    return _resolve_scan(plan.child, e.name)
                return None
        return None
    if isinstance(plan, JoinPlan):
        lf = plan.left.output_fields()
        names = [f.name for f in plan.fields]
        try:
            i = [x.lower() for x in names].index(nl)
        except ValueError:
            return None
        if i < len(lf):
            return _resolve_scan(plan.left, lf[i].name)
        return _resolve_scan(plan.right,
                             plan.right.output_fields()[i - len(lf)].name)
    return None
