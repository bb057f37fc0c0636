"""Cost-based plan optimizer: filter pushdown + join reordering.

The reference runs a cascades optimizer with a recursive rule list and a
DP join reorderer (src/query/sql/src/planner/optimizer/optimizers/
{cascades,recursive,rule,hyper_dp}, entry planner.rs:92). This engine
matches the *behavior* — predicates land in scan pushdowns, inner-join
regions are re-ordered by estimated cardinality via dynamic programming —
with a far smaller rewrite pass suited to the single-tier plan tree:

1. Extract each maximal region of INNER joins + filters into a join graph
   (relations, equi edges, residual predicates), with every predicate
   rewritten to region-global column names.
2. Push single-relation conjuncts into the relation (down to the Scan
   pushdown, through projections).
3. Enumerate join orders with DP over subsets (exact for <= 10 relations,
   greedy chaining beyond), costing by estimated intermediate rows; the
   build (right) side of every hash join is the smaller input.
4. Re-project to the region's original output names.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Set, Tuple

from ...expression.expr import (BoundColumn, CaseExpr, CastExpr, Constant,
                                Func, ScalarExpr)
from ...types import Boolean
from ..plans import (AggregatePlan, DistinctPlan, FilterPlan, JoinPlan,
                     LimitPlan, Plan, ProjectPlan, Scan, SortPlan,
                     UnionAllPlan, ValuesPlan, WindowPlan)
from .stats import Estimator

MAX_DP_RELATIONS = 10


def optimize(plan: Plan, session) -> Plan:
    """Entry point: rewrite the bound plan tree (reference planner.rs:92
    `optimize()` after bind)."""
    cbo = True
    try:
        cbo = bool(session.settings.get("enable_cbo"))
    except Exception:
        pass
    # Undo any pruning a PREVIOUS optimize() left on shared subtrees (a
    # CTE referenced by a bind-time-folded scalar subquery, TPC-H q15)
    # BEFORE region extraction reads output_fields().
    _restore_pruned(plan, set())
    out = _Optimizer(session).rewrite(plan) if cbo else plan
    if cbo:
        out = _transform_post(out, _rewrite_affine_sums)
    out = _transform_post(out, _mark_agg_index)
    prune_scan_columns(out)
    return out


def _mark_agg_index(plan: Plan) -> Plan:
    """Plan-level AGGREGATING INDEX rewrite marker (reference agg_index
    pushdown, pushdown.rs:167-207): EXPLAIN surfaces the index-only scan
    and execution answers from per-block partials without reading data
    blocks."""
    if isinstance(plan, AggregatePlan) and plan.agg_index is None:
        from ...pipeline.executor import match_agg_index
        try:
            m = match_agg_index(plan)
        except Exception:
            m = None
        if m is not None:
            plan.agg_index = m[0].name
    return plan


def _transform_post(plan: Plan, f) -> Plan:
    """Post-order plan transform (children first, then the node)."""
    from ..plans import DistinctPlan, LateralFlattenPlan, SetOpPlan
    if isinstance(plan, (FilterPlan, ProjectPlan, AggregatePlan, SortPlan,
                         LimitPlan, WindowPlan, DistinctPlan,
                         LateralFlattenPlan)):
        plan.child = _transform_post(plan.child, f)
    elif isinstance(plan, (JoinPlan, SetOpPlan)):
        plan.left = _transform_post(plan.left, f)
        plan.right = _transform_post(plan.right, f)
    elif isinstance(plan, UnionAllPlan):
        plan.inputs = [_transform_post(c, f) for c in plan.inputs]
    return f(plan)


def _decompose_affine(e: ScalarExpr):
    """sum-arg `k*base + c` decomposition for plus/minus with a numeric
    literal: returns (base_expr, k, c) or None."""
    if not isinstance(e, Func) or e.name not in ("plus", "minus") \
            or len(e.args) != 2:
        return None
    a, b = e.args
    for const, base, swapped in ((b, a, False), (a, b, True)):
        if isinstance(const, Constant) \
                and isinstance(const.value, (int, float)) \
                and not isinstance(const.value, bool) \
                and not isinstance(base, Constant):
            if e.name == "plus":
                return (base, 1, const.value)
            # minus: base - c  |  c - base
            return (base, -1, const.value) if swapped else (base, 1, -const.value)
    return None


def _rewrite_affine_sums(plan: Plan) -> Plan:
    """SUM(x ± c) -> SUM(x) ± c*COUNT(x): dedupes the base column's sum
    and count once, then computes each affine output in a projection
    (ClickBench q29's 90 sums collapse to one sum + one count). Applied
    when at least two aggregates share the rewrite."""
    if not isinstance(plan, AggregatePlan):
        return plan
    from ...expression.functions.aggregates import CountAgg, SumAgg
    from ...types import Float64, Int64
    affine = {}
    for name, fn, args in plan.aggs:
        if getattr(fn, "name", "") == "sum" and not fn.distinct \
                and len(args) == 1:
            d = _decompose_affine(args[0])
            if d is not None and d[0].dtype.remove_nullable().is_numeric():
                affine[name] = d
    if len(affine) < 2:
        return plan
    base_slots: Dict[str, Tuple[int, ScalarExpr]] = {}
    new_aggs = []
    for name, fn, args in plan.aggs:
        if name not in affine:
            new_aggs.append((name, fn, args))
    items: List[Tuple[str, ScalarExpr]] = []
    for kname, kexpr in plan.keys:
        items.append((kname, BoundColumn(kname, kexpr.dtype)))
    for name, fn, args in plan.aggs:
        if name not in affine:
            rt = fn.return_type()
            if not name.startswith("count"):
                rt = rt.wrap_nullable()
            items.append((name, BoundColumn(name, rt)))
            continue
        base, k, c = affine[name]
        key = base.display()
        if key not in base_slots:
            i = len(base_slots)
            base_slots[key] = (i, base)
            new_aggs.append((f"__afs{i}", SumAgg([base.dtype]), [base]))
            new_aggs.append((f"__afc{i}", CountAgg([base.dtype]), [base]))
        i, _ = base_slots[key]
        srt = SumAgg([base.dtype]).return_type().wrap_nullable()
        s_col = BoundColumn(f"__afs{i}", srt)
        n_col = BoundColumn(f"__afc{i}", Int64)
        cdt = Float64 if isinstance(c, float) else Int64
        expr: ScalarExpr = s_col if k == 1 else Func(
            "negate", [s_col], srt)
        if c != 0:
            expr = Func("plus", [expr, Func(
                "multiply", [Constant(c, cdt), CastExpr(n_col, Int64, True)],
                cdt)], srt)
        items.append((name, CastExpr(expr, fn.return_type().wrap_nullable(),
                                     True)))
    plan.aggs = new_aggs
    return ProjectPlan(plan, items)


# ------------------------------------------------------- column pruning

def prune_scan_columns(plan: Plan) -> None:
    """Projection pushdown: compute the base columns each Scan must
    materialize and record them in Scan.columns (reference: column
    pruning / PushDownInfo.projection). Two phases — a top-down collect
    that UNIONS requirements per Scan object (the binder shares Scans,
    e.g. across UNPIVOT's UNION branches), then assignment plus a
    post-order re-alignment of positional join output fields. A node
    type without a rule falls back to "all columns" (always correct).
    Qualified names ('f.k') match schema names by suffix."""
    # Plans can be SHARED across optimize() calls (a CTE referenced both
    # by the main query and by a bind-time-folded scalar subquery, TPC-H
    # q15). Pruning is destructive, so first restore any node this pass
    # might re-prune to its pre-prune state — each call then prunes from
    # the full column set for ITS requirements.
    _restore_pruned(plan, set())
    reqs: Dict[int, Optional[Set[str]]] = {}
    scans: Dict[int, Scan] = {}
    joins: List[Tuple[JoinPlan, list, list]] = []
    projs: Dict[int, tuple] = {}
    _collect_reqs(plan, None, reqs, scans, joins, projs)
    # prune unused projection items (the binder's explicit-JOIN output
    # projections re-materialize every column; TPC-DS q72 carried 110
    # columns through a multi-million-row join chain). Requirements were
    # UNIONED per Project object first — CTE plans are shared.
    pruned_any = False
    for pid, (pp, preq) in projs.items():
        if preq is None or len(pp.items) <= 1:
            continue
        suffixes = {q.rsplit(".", 1)[-1] for q in preq}
        kept = [(n, e) for n, e in pp.items
                if n.lower() in preq
                or n.lower().rsplit(".", 1)[-1] in suffixes]
        if not kept:
            kept = pp.items[:1]
        if len(kept) < len(pp.items):
            pp._pruned_items_orig = pp.items
            pp.items = kept
            pruned_any = True
    if pruned_any:   # recollect scan requirements with narrowed projects.
        # NOTE: keep the FIRST collect's `joins` — its before-field lists
        # are positionally aligned with each join's original `fields`,
        # which is what the realignment mask below zips against.
        reqs, scans = {}, {}
        _collect_reqs(plan, None, reqs, scans, [], None)
    for sid, scan in scans.items():
        req = reqs[sid]
        if req is None:
            continue
        names = set(req)
        if scan.pushdown.filters is not None:
            names |= column_names(scan.pushdown.filters)
        suffixes = {q.rsplit(".", 1)[-1] for q in names}
        keep = [f.name for f in scan.table.schema.fields
                if f.name.lower() in names or f.name.lower() in suffixes]
        if not keep:  # zero-column blocks lose their row count: keep one
            keep = [scan.table.schema.fields[0].name]
        if len(keep) < len(scan.table.schema.fields):
            scan._columns_pruned = True
            scan.columns = keep
    # joins were appended top-down; reversed = children realign first
    seen_joins: Set[int] = set()
    for jp, lf_before, rf_before in reversed(joins):
        if id(jp) in seen_joins:
            continue  # shared node: realign exactly once
        seen_joins.add(id(jp))
        lkeep = {f.name for f in jp.left.output_fields()}
        rkeep = {f.name for f in jp.right.output_fields()}
        if len(lkeep) == len(lf_before) and len(rkeep) == len(rf_before):
            continue
        mask = [f.name in lkeep for f in lf_before] + \
               [f.name in rkeep for f in rf_before]
        if jp.all_fields is not None:  # SEMI/ANTI: fields = left side only
            jp._all_fields_orig = jp.all_fields
            jp._fields_orig = jp.fields
            jp.all_fields = [f for f, k in zip(jp.all_fields, mask) if k]
            jp.fields = [f for f, k in
                         zip(jp.fields, mask[:len(lf_before)]) if k]
        else:
            jp._fields_orig = jp.fields
            jp.fields = [f for f, k in zip(jp.fields, mask) if k]


def _restore_pruned(plan: Plan, seen: Set[int]) -> None:
    """Undo a previous prune_scan_columns pass on this (possibly shared)
    plan tree so the current pass starts from full column sets."""
    if id(plan) in seen:
        return
    seen.add(id(plan))
    if isinstance(plan, ProjectPlan):
        orig = getattr(plan, "_pruned_items_orig", None)
        if orig is not None:
            plan.items = orig
            plan._pruned_items_orig = None
    elif isinstance(plan, Scan):
        if getattr(plan, "_columns_pruned", False):
            plan.columns = None
            plan._columns_pruned = False
    elif isinstance(plan, JoinPlan):
        orig = getattr(plan, "_fields_orig", None)
        if orig is not None:
            plan.fields = orig
            plan._fields_orig = None
        orig = getattr(plan, "_all_fields_orig", None)
        if orig is not None:
            plan.all_fields = orig
            plan._all_fields_orig = None
    for ch in plan.children():
        _restore_pruned(ch, seen)


def _node_ids(plan: Plan, acc: Set[int]) -> None:
    acc.add(id(plan))
    for ch in plan.children():
        _node_ids(ch, acc)


def _names_of(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        if e is not None:
            out |= column_names(e)
    return out


def _merge_req(reqs, scans, scan: Scan, req: Optional[Set[str]]) -> None:
    sid = id(scan)
    scans[sid] = scan
    if sid in reqs and reqs[sid] is None:
        return
    if req is None:
        reqs[sid] = None
    else:
        reqs.setdefault(sid, set())
        reqs[sid] |= req


def _collect_reqs(plan: Plan, req: Optional[Set[str]], reqs, scans,
                  joins, projs=None) -> None:
    from ..plans import LateralFlattenPlan
    if isinstance(plan, Scan):
        _merge_req(reqs, scans, plan, req)
        return
    if isinstance(plan, ProjectPlan):
        if projs is not None:
            pid = id(plan)
            prev = projs.get(pid)
            if prev is not None and prev[1] is None:
                pass                      # already "keep all"
            elif req is None:
                projs[pid] = (plan, None)
            elif prev is None:
                projs[pid] = (plan, set(req))
            else:
                projs[pid] = (plan, prev[1] | req)
        _collect_reqs(plan.child, _names_of(e for _, e in plan.items),
                      reqs, scans, joins, projs)
        return
    if isinstance(plan, FilterPlan):
        _collect_reqs(plan.child,
                      None if req is None else req | column_names(plan.expr),
                      reqs, scans, joins, projs)
        return
    if isinstance(plan, AggregatePlan):
        need = _names_of(e for _, e in plan.keys)
        for _n, _f, args in plan.aggs:
            need |= _names_of(args)
        _collect_reqs(plan.child, need, reqs, scans, joins, projs)
        return
    if isinstance(plan, SortPlan):
        _collect_reqs(plan.child, None if req is None
                      else req | {i.name.lower() for i in plan.items},
                      reqs, scans, joins, projs)
        return
    if isinstance(plan, LimitPlan):
        _collect_reqs(plan.child, req, reqs, scans, joins, projs)
        return
    if isinstance(plan, JoinPlan):
        if req is None:
            _collect_reqs(plan.left, None, reqs, scans, joins, projs)
            _collect_reqs(plan.right, None, reqs, scans, joins, projs)
            return
        need = (req | _names_of(plan.left_keys)
                | _names_of(plan.right_keys)
                | _names_of([plan.residual]))
        joins.append((plan, plan.left.output_fields(),
                      plan.right.output_fields()))
        _collect_reqs(plan.left, need, reqs, scans, joins, projs)
        _collect_reqs(plan.right, need, reqs, scans, joins, projs)
        return
    if isinstance(plan, WindowPlan):
        if req is None:
            _collect_reqs(plan.child, None, reqs, scans, joins, projs)
            return
        need = set(req)
        for it in plan.items:
            need |= _names_of(it.args)
            need |= _names_of(it.partition_by)
            need |= _names_of(e for e, _a, _nf in it.order_by)
        _collect_reqs(plan.child, need, reqs, scans, joins, projs)
        return
    if isinstance(plan, LateralFlattenPlan):
        _collect_reqs(plan.child, None if req is None
                      else req | column_names(plan.input_expr),
                      reqs, scans, joins, projs)
        return
    # DistinctPlan, UnionAllPlan, SetOpPlan, unknown nodes: the full child
    # output is semantically significant (dedup / positional union)
    for ch in plan.children():
        _collect_reqs(ch, None, reqs, scans, joins, projs)


# ----------------------------------------------------------- expression utils

def conjuncts(e: Optional[ScalarExpr]) -> List[ScalarExpr]:
    if e is None:
        return []
    if isinstance(e, Func) and e.name == "and":
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    factored = _factor_common_or(e)
    if factored is not None:
        return factored
    return [e]


def _or_disjuncts(e: ScalarExpr) -> List[ScalarExpr]:
    if isinstance(e, Func) and e.name == "or":
        out = []
        for a in e.args:
            out.extend(_or_disjuncts(a))
        return out
    return [e]


def _factor_common_or(e: ScalarExpr) -> Optional[List[ScalarExpr]]:
    """(A AND X) OR (A AND Y) -> [A, (X OR Y)] — common-predicate
    extraction over a disjunction (reference: the filter normalization
    rule). TPC-H q19's `p_partkey = l_partkey` join predicate hides in
    every disjunct; without this the join degenerates to a cross join."""
    if not (isinstance(e, Func) and e.name == "or"):
        return None
    ds = _or_disjuncts(e)
    if len(ds) < 2:
        return None
    conj_lists = [conjuncts(d) if not (isinstance(d, Func)
                                       and d.name == "or")
                  else [d] for d in ds]
    # conjuncts() on a non-or disjunct can recurse back here only for
    # nested ors, which _or_disjuncts already flattened
    key_maps = [{c.display(): c for c in cl} for cl in conj_lists]
    common = set(key_maps[0])
    for km in key_maps[1:]:
        common &= set(km)
    if not common:
        return None
    out = [key_maps[0][k] for k in sorted(common)]
    rest_parts = []
    for cl in conj_lists:
        rem = [c for c in cl if c.display() not in common]
        if not rem:
            return out  # one disjunct is exactly the common part: OR is
            # implied true given it -> keep only the common conjuncts
        rest_parts.append(and_all(rem))
    rest = rest_parts[0]
    for p in rest_parts[1:]:
        rest = Func("or", [rest, p], Boolean)
    out.append(rest)
    return out


def and_all(parts: List[ScalarExpr]) -> Optional[ScalarExpr]:
    acc = None
    for p in parts:
        acc = p if acc is None else Func("and", [acc, p], Boolean)
    return acc


def rename_columns(e: ScalarExpr, ren: Dict[str, str]) -> ScalarExpr:
    if isinstance(e, BoundColumn):
        new = ren.get(e.name.lower())
        return BoundColumn(new, e.dtype, e.table) if new is not None and \
            new != e.name else e
    if isinstance(e, Func):
        return Func(e.name, [rename_columns(a, ren) for a in e.args], e.dtype)
    if isinstance(e, CastExpr):
        return CastExpr(rename_columns(e.arg, ren), e.dtype, e.is_try)
    if isinstance(e, CaseExpr):
        return CaseExpr([rename_columns(c, ren) for c in e.conditions],
                        [rename_columns(r, ren) for r in e.results],
                        rename_columns(e.else_result, ren)
                        if e.else_result is not None else None, e.dtype)
    return e


def column_names(e: ScalarExpr) -> Set[str]:
    from ...expression.expr import ArrayLambda
    out: Set[str] = set()
    for x in e.walk():
        if isinstance(x, BoundColumn):
            out.add(x.name.lower())
        elif isinstance(x, ArrayLambda):
            # lambda bodies close over outer columns; the lambda's own
            # parameters are element-block locals, not table columns
            inner = column_names(x.body)
            out |= inner - {p.lower() for p in x.param_cols} \
                - {p.lower() for p in x.params}
    return out


# ------------------------------------------------------------------ join graph

@dataclass
class EquiPred:
    lexpr: ScalarExpr
    rexpr: ScalarExpr
    lrels: frozenset
    rrels: frozenset

    @property
    def rels(self) -> frozenset:
        return self.lrels | self.rrels


@dataclass
class FilterPred:
    expr: ScalarExpr
    rels: frozenset


@dataclass
class Region:
    rels: List[Plan] = dc_field(default_factory=list)
    rel_names: List[Set[str]] = dc_field(default_factory=list)
    equis: List[EquiPred] = dc_field(default_factory=list)
    filters: List[FilterPred] = dc_field(default_factory=list)
    out_fields: list = dc_field(default_factory=list)


class _Optimizer:
    def __init__(self, session):
        self.session = session
        self.est = Estimator(session)
        self._rows_cache: Dict[tuple, float] = {}

    # ------------------------------------------------------------- traversal
    def rewrite(self, plan: Plan) -> Plan:
        if self._is_region_root(plan):
            return self._optimize_region(plan)
        if isinstance(plan, FilterPlan):
            child = self.rewrite(plan.child)
            return self._push_filter(child, plan.expr)
        # generic: rewrite children in place
        if isinstance(plan, (ProjectPlan, SortPlan, LimitPlan, DistinctPlan,
                             WindowPlan, AggregatePlan)):
            plan.child = self.rewrite(plan.child)
            return plan
        if isinstance(plan, UnionAllPlan):
            plan.inputs = [self.rewrite(c) for c in plan.inputs]
            return plan
        if isinstance(plan, JoinPlan):  # non-inner join: sides independently
            plan.left = self.rewrite(plan.left)
            plan.right = self.rewrite(plan.right)
            return plan
        from ..plans import SetOpPlan
        if isinstance(plan, SetOpPlan):  # INTERSECT/EXCEPT arms
            plan.left = self.rewrite(plan.left)
            plan.right = self.rewrite(plan.right)
            return plan
        return plan

    @staticmethod
    def _is_region_root(plan: Plan) -> bool:
        node = plan
        while isinstance(node, FilterPlan):
            node = node.child
        return isinstance(node, JoinPlan) and node.kind in ("INNER",
                                                            "CROSS")

    # ------------------------------------------------------ filter pushdown
    def _push_filter(self, plan: Plan, expr: ScalarExpr) -> Plan:
        """Push a predicate as deep as its columns allow."""
        if isinstance(plan, Scan):
            base = {f.name.lower() for f in plan.table.schema.fields}
            if column_names(expr) <= base:
                pd = plan.pushdown
                pd.filters = expr if pd.filters is None else \
                    Func("and", [pd.filters, expr], Boolean)
                return plan
            return FilterPlan(plan, expr)
        if isinstance(plan, ProjectPlan):
            sub = {n.lower(): e for n, e in plan.items}
            if column_names(expr) <= set(sub):
                inlined = _substitute(expr, sub)
                if inlined is not None:
                    plan.child = self._push_filter(plan.child, inlined)
                    return plan
            return FilterPlan(plan, expr)
        if isinstance(plan, FilterPlan):
            plan.child = self._push_filter(plan.child, expr)
            return plan
        if isinstance(plan, JoinPlan) and plan.kind in ("SEMI", "ANTI",
                                                        "LEFT"):
            # these joins pass the probe side through unchanged, so any
            # conjunct over probe columns pushes below (the decorrelated
            # TPC-H q21 shape: equi conjuncts must reach the base-table
            # region under the SEMI/ANTI joins, not sit above them)
            left_names = {f.name.lower()
                          for f in plan.left.output_fields()}
            push = [c for c in conjuncts(expr)
                    if column_names(c) <= left_names]
            keep = [c for c in conjuncts(expr)
                    if not (column_names(c) <= left_names)]
            if push:
                plan.left = self._push_filter(plan.left, and_all(push))
                plan.left = self.rewrite(plan.left)
                rest = and_all(keep)
                return plan if rest is None else FilterPlan(plan, rest)
        return FilterPlan(plan, expr)

    # ------------------------------------------------------- region handling
    def _optimize_region(self, plan: Plan) -> Plan:
        region = Region(out_fields=plan.output_fields())
        out_names = [f.name for f in region.out_fields]
        self._collect(plan, out_names, region)
        n = len(region.rels)
        # rewrite leaves first (nested regions under non-inner joins etc.)
        region.rels = [self.rewrite(r) for r in region.rels]
        self._finalize_predicates(region)

        # push single-relation filters into their relation. A relation
        # whose subtree shares nodes with another relation (a CTE
        # referenced twice, TPC-DS q39's inv1/inv2) must NOT be mutated —
        # pushing inv1's d_moy=1 into the shared plan would also filter
        # inv2; wrap those in a FilterPlan instead.
        id_sets = []
        for r in region.rels:
            s: Set[int] = set()
            _node_ids(r, s)
            id_sets.append(s)
        shared_rels: Set[int] = set()
        for i in range(len(id_sets)):
            for j in range(i + 1, len(id_sets)):
                if id_sets[i] & id_sets[j]:
                    shared_rels.add(i)
                    shared_rels.add(j)
        remaining: List[FilterPred] = []
        for f in region.filters:
            if len(f.rels) == 1:
                (i,) = tuple(f.rels)
                if i in shared_rels:
                    region.rels[i] = FilterPlan(region.rels[i], f.expr)
                else:
                    region.rels[i] = self._push_filter(region.rels[i],
                                                       f.expr)
            else:
                remaining.append(f)
        region.filters = remaining

        ordered = self._enumerate(region)
        # restore original output order / names
        fields_by_name = {f.name.lower(): f for f in region.out_fields}
        got = [f.name for f in ordered.output_fields()]
        if got != [f.name for f in region.out_fields]:
            ordered = ProjectPlan(ordered, [
                (f.name, BoundColumn(f.name, f.dtype))
                for f in region.out_fields])
        return ordered

    def _collect(self, node: Plan, out_names: List[str], region: Region):
        own = [f.name for f in node.output_fields()]
        ren = {o.lower(): n for o, n in zip(own, out_names)}
        if isinstance(node, FilterPlan):
            for c in conjuncts(rename_columns(node.expr, ren)):
                region.filters.append(FilterPred(c, frozenset()))  # rels later
            self._collect(node.child, out_names, region)
            return
        if isinstance(node, JoinPlan) and node.kind in ("INNER", "CROSS"):
            lf = node.left.output_fields()
            l_out = out_names[:len(lf)]
            r_out = out_names[len(lf):]
            l_own = [f.name for f in lf]
            r_own = [f.name for f in node.right.output_fields()]
            lren = {o.lower(): x for o, x in zip(l_own, l_out)}
            rren = {o.lower(): x for o, x in zip(r_own, r_out)}
            for lk, rk in zip(node.left_keys, node.right_keys):
                region.equis.append(EquiPred(
                    rename_columns(lk, lren), rename_columns(rk, rren),
                    frozenset(), frozenset()))  # rels later
            if node.residual is not None:
                for c in conjuncts(rename_columns(node.residual, ren)):
                    region.filters.append(FilterPred(c, frozenset()))
            self._collect(node.left, l_out, region)
            self._collect(node.right, r_out, region)
            return
        # leaf relation — rename its outputs to the region-global names
        leaf = node
        if any(o.lower() != x.lower() for o, x in zip(own, out_names)):
            leaf = ProjectPlan(node, [
                (x, BoundColumn(o, f.dtype))
                for o, x, f in zip(own, out_names, node.output_fields())])
        region.rels.append(leaf)
        region.rel_names.append({x.lower() for x in out_names})
        # once all leaves are known, predicates get their rel sets filled by
        # _finalize_predicates (called lazily from _enumerate)

    def _rels_of(self, region: Region, names: Set[str]) -> frozenset:
        out = set()
        for i, owned in enumerate(region.rel_names):
            if names & owned:
                out.add(i)
        return frozenset(out)

    def _finalize_predicates(self, region: Region):
        equis: List[EquiPred] = []
        for e in region.equis:
            lrels = self._rels_of(region, column_names(e.lexpr))
            rrels = self._rels_of(region, column_names(e.rexpr))
            if lrels and rrels and not (lrels & rrels):
                equis.append(EquiPred(e.lexpr, e.rexpr, lrels, rrels))
            else:  # degenerate key (constant or same-side): generic filter
                region.filters.append(FilterPred(
                    Func("eq", [e.lexpr, e.rexpr], Boolean), lrels | rrels))
        region.equis = equis
        filters: List[FilterPred] = []
        for f in region.filters:
            names = column_names(f.expr)
            rels = self._rels_of(region, names)
            # an eq conjunct bridging exactly two sides upgrades to a key
            if isinstance(f.expr, Func) and f.expr.name == "eq" \
                    and len(f.expr.args) == 2:
                a, b = f.expr.args
                ra = self._rels_of(region, column_names(a))
                rb = self._rels_of(region, column_names(b))
                if ra and rb and not (ra & rb):
                    region.equis.append(EquiPred(a, b, ra, rb))
                    continue
            filters.append(FilterPred(f.expr, rels))
        region.filters = filters

    # -------------------------------------------------------- DP enumeration
    def _enumerate(self, region: Region) -> Plan:
        n = len(region.rels)
        rows = [max(self.est.rows(r), 1.0) for r in region.rels]
        pred_sel = self._pred_selectivities(region, rows)

        def subset_rows(mask: int) -> float:
            r = 1.0
            for i in range(n):
                if mask >> i & 1:
                    r *= rows[i]
            for p, sel in pred_sel:
                if p & mask == p:
                    r *= sel
            return max(r, 1.0)

        try:
            if self.session.settings.get("disable_join_reorder"):
                return self._written_order(region, subset_rows)
            dphyp = bool(self.session.settings.get("enable_dphyp"))
        except Exception:
            dphyp = True
        if n > MAX_DP_RELATIONS or not dphyp:
            return self._greedy(region, rows, subset_rows)

        # DP over subsets: best[mask] = (cost, plan, applied_filter_ids)
        best: Dict[int, Tuple[float, Plan]] = {}
        for i in range(n):
            best[1 << i] = (0.0, region.rels[i])
        full = (1 << n) - 1
        for mask in sorted(range(1, full + 1), key=lambda m: bin(m).count("1")):
            if bin(mask).count("1") < 2:
                continue
            out_rows = subset_rows(mask)
            # iterate proper subsets s1 of mask
            s1 = (mask - 1) & mask
            while s1:
                s2 = mask ^ s1
                if s1 < s2:  # each unordered split once
                    cand = self._try_join(region, best, s1, s2, out_rows)
                    if cand is not None and (mask not in best
                                             or cand[0] < best[mask][0]):
                        best[mask] = cand
                s1 = (s1 - 1) & mask
        return self._attach_filters(region, best[full][1], full)

    def _pred_selectivities(self, region: Region, rows: List[float]):
        out = []
        for e in region.equis:
            mask = 0
            for i in e.rels:
                mask |= 1 << i
            ndv_l = self._side_ndv(region, e.lexpr, e.lrels, rows)
            ndv_r = self._side_ndv(region, e.rexpr, e.rrels, rows)
            out.append((mask, 1.0 / max(ndv_l, ndv_r, 1.0)))
        for f in region.filters:
            if len(f.rels) >= 2:
                mask = 0
                for i in f.rels:
                    mask |= 1 << i
                out.append((mask, self.est.selectivity(f.expr, None)))
        return out

    def _side_ndv(self, region: Region, expr: ScalarExpr,
                  rels: frozenset, rows: List[float]) -> float:
        if len(rels) == 1:
            (i,) = tuple(rels)
            return self.est.expr_ndv(expr, region.rels[i], rows[i])
        r = 1.0
        for i in rels:
            r *= rows[i]
        return r

    def _try_join(self, region: Region, best, s1: int, s2: int,
                  out_rows: float):
        if s1 not in best or s2 not in best:
            return None
        c1, p1 = best[s1]
        c2, p2 = best[s2]
        keys = self._keys_between(region, s1, s2)
        if not keys:
            # allow cartesian, DP's cost model will avoid it when possible
            keys = []
        cost = c1 + c2 + out_rows
        # keep probe on the larger side: build (right) side smaller
        r1, r2 = self._plan_rows_cached(p1, s1), self._plan_rows_cached(p2, s2)
        if r1 >= r2:
            left, right, lk, rk = p1, p2, [a for a, _ in keys], [b for _, b in keys]
            ls, rs = s1, s2
        else:
            left, right, lk, rk = p2, p1, [b for _, b in keys], [a for a, _ in keys]
            ls, rs = s2, s1
        resid = self._residual_for(region, ls, rs)
        fields = left.output_fields() + right.output_fields()
        j = JoinPlan("INNER" if keys else "CROSS", left, right, lk, rk,
                     resid, fields,
                     distributed=self._distributed_on(),
                     spill_threshold_rows=self._join_spill_rows())
        return (cost, j)

    def _join_spill_rows(self):
        try:
            return int(self.session.settings.get(
                "join_spill_row_threshold")) or None
        except Exception:
            return None

    def _distributed_on(self) -> bool:
        # reordered JoinPlans must keep the bind-time exchange
        # eligibility (the reorder rebuilds the plan nodes from scratch)
        try:
            return bool(self.session.settings.get(
                "enable_distributed_execution"))
        except Exception:
            return False

    def _written_order(self, region: Region, subset_rows) -> Plan:
        """disable_join_reorder: left-deep chain in the written FROM order,
        sides kept as written (reference setting of the same name)."""
        n = len(region.rels)
        mask = 1
        plan = region.rels[0]
        for i in range(1, n):
            s2 = 1 << i
            keys = self._keys_between(region, mask, s2)
            lk = [a for a, _ in keys]
            rk = [b for _, b in keys]
            resid = self._residual_for(region, mask, s2)
            fields = plan.output_fields() + region.rels[i].output_fields()
            plan = JoinPlan("INNER" if keys else "CROSS", plan,
                            region.rels[i], lk, rk, resid, fields,
                            distributed=self._distributed_on(),
                            spill_threshold_rows=self._join_spill_rows())
            mask |= s2
        return self._attach_filters(region, plan, mask)

    def _plan_rows_cached(self, plan: Plan, mask: int) -> float:
        key = (id(plan), mask)
        v = self._rows_cache.get(key)
        if v is None:
            v = self.est.rows(plan)
            self._rows_cache[key] = v
        return v

    def _keys_between(self, region: Region, s1: int, s2: int):
        """Equi keys usable when joining rel-sets s1 (left) and s2 (right):
        returns [(left_expr, right_expr)] oriented to (s1, s2)."""
        keys = []
        for e in region.equis:
            lm = _mask(e.lrels)
            rm = _mask(e.rrels)
            if lm & s1 == lm and rm & s2 == rm:
                keys.append((e.lexpr, e.rexpr))
            elif lm & s2 == lm and rm & s1 == rm:
                keys.append((e.rexpr, e.lexpr))
        return keys

    def _residual_for(self, region: Region, s1: int, s2: int):
        """Filters that become evaluable exactly when s1 and s2 join."""
        s = s1 | s2
        parts = []
        for f in region.filters:
            m = _mask(f.rels)
            if m and m & s == m and not (m & s1 == m) and not (m & s2 == m):
                parts.append(f.expr)
        return and_all(parts)

    def _attach_filters(self, region: Region, plan: Plan, full: int) -> Plan:
        """Anything not applied inside the tree (rel-free predicates)."""
        parts = [f.expr for f in region.filters if not f.rels]
        e = and_all(parts)
        return FilterPlan(plan, e) if e is not None else plan

    # ---------------------------------------------------------------- greedy
    def _greedy(self, region: Region, rows, subset_rows) -> Plan:
        n = len(region.rels)
        alive = {1 << i: region.rels[i] for i in range(n)}
        while len(alive) > 1:
            best_pair = None
            for s1, s2 in itertools.combinations(alive, 2):
                joined = subset_rows(s1 | s2)
                connected = bool(self._keys_between(region, s1, s2))
                score = (0 if connected else 1, joined)
                if best_pair is None or score < best_pair[0]:
                    best_pair = (score, s1, s2)
            _, s1, s2 = best_pair
            out_rows = subset_rows(s1 | s2)
            cand = self._try_join(
                region, {s1: (0.0, alive[s1]), s2: (0.0, alive[s2])},
                s1, s2, out_rows)
            del alive[s1], alive[s2]
            alive[s1 | s2] = cand[1]
        (full, plan), = alive.items()
        return self._attach_filters(region, plan, full)


def _mask(rels: frozenset) -> int:
    m = 0
    for i in rels:
        m |= 1 << i
    return m


def _substitute(e: ScalarExpr, sub: Dict[str, ScalarExpr]) -> Optional[ScalarExpr]:
    """Inline projection items into a predicate (for pushdown through
    ProjectPlan). Returns None if some referenced name has no mapping."""
    if isinstance(e, BoundColumn):
        return sub.get(e.name.lower())
    if isinstance(e, Constant):
        return e
    if isinstance(e, Func):
        args = [_substitute(a, sub) for a in e.args]
        if any(a is None for a in args):
            return None
        return Func(e.name, args, e.dtype)
    if isinstance(e, CastExpr):
        a = _substitute(e.arg, sub)
        return CastExpr(a, e.dtype, e.is_try) if a is not None else None
    if isinstance(e, CaseExpr):
        cs = [_substitute(c, sub) for c in e.conditions]
        rs = [_substitute(r, sub) for r in e.results]
        el = _substitute(e.else_result, sub) if e.else_result is not None else None
        if any(x is None for x in cs + rs) or \
                (e.else_result is not None and el is None):
            return None
        return CaseExpr(cs, rs, el, e.dtype)
    return None
