"""Query binder: AST -> Plan.

Analog of the reference's Binder + semantic rewrites (reference:
src/query/sql/src/planner/binder/ and semantic/type_check/):

* KNN rewrite — ``<distance_fn>(vector_col, const)`` over a table with a
  matching VECTOR INDEX becomes the ``_vector_score`` internal column with
  a VectorIndexInfo pushdown (reference type_check/vector.rs:70-120);
  HNSW top-k pruning is enabled exactly when the reference would:
  no residual filter, ASC order on the score, LIMIT present
  (vector_index_pruner.rs:178-240). Non-rewritten distance calls still
  evaluate as ordinary scalar functions.
* Search rewrite — ``match()``/``query()``/``score()`` become
  ``_search_matched``/``_search_score`` + InvertedIndexInfo pushdown
  (reference type_check/search.rs:129-293).
* Predicates and limits push into the Scan for pruning.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..catalog.pushdown import (InvertedIndexInfo, PushDownInfo, Range,
                                VectorIndexInfo)
from ..errors import SemanticError, UnknownIndex, UnknownTable
from ..expression import DataBlock, DataField
from ..expression.evaluator import infer_literal_type
from ..expression.expr import (BoundColumn, CastExpr, Constant, Func,
                               ScalarExpr)
from ..expression.functions import registry
from ..expression.functions.aggregates import create_aggregate, is_aggregate_function
from ..expression.schema import (SEARCH_MATCHED_COL_NAME,
                                 SEARCH_SCORE_COL_NAME, VECTOR_SCORE_COL_NAME)
from ..types import Boolean, Float32, Float64, Int64, VectorType
from . import ast as A
from .expr_binder import BindContext, ExprBinder
from .plans import (AggregatePlan, DistinctPlan, FilterPlan, JoinPlan,
                    LimitPlan, Plan, ProjectPlan, Scan, SortItem, SortPlan,
                    UnionAllPlan, ValuesPlan, WindowItem, WindowPlan)

_DISTANCE_FNS = {"cosine_distance": "cosine", "l2_distance": "l2",
                 "l1_distance": "l1"}

# pure window functions (aggregates used with OVER are also valid windows)
_WINDOW_ONLY_FNS = {"row_number", "rank", "dense_rank", "ntile",
                    "percent_rank", "cume_dist", "lag", "lead",
                    "first_value", "last_value"}


def _window_return_type(name: str, args: List[ScalarExpr]):
    if name in ("row_number", "rank", "dense_rank", "ntile"):
        return Int64
    if name in ("percent_rank", "cume_dist"):
        return Float64
    if name in ("lag", "lead", "first_value", "last_value"):
        if not args:
            raise SemanticError(f"{name}() expects at least one argument")
        return args[0].dtype.wrap_nullable()
    fn = create_aggregate(name, [a.dtype for a in args], False)
    rt = fn.return_type()
    return rt if name.startswith("count") else rt.wrap_nullable()


@dataclass
class ScanState:
    """Rewrite bookkeeping for a single-table SELECT."""

    scan: Optional[Scan] = None
    table_info: Optional[object] = None
    vector_rewrite: Optional[VectorIndexInfo] = None
    inverted_rewrite: Optional[InvertedIndexInfo] = None
    used_score_fn: bool = False


class SelectExprBinder(ExprBinder):
    """ExprBinder + index-aware rewrites."""

    def __init__(self, ctx: BindContext, state: ScanState,
                 aggregate_handler=None, subquery_handler=None,
                 window_handler=None):
        super().__init__(ctx, aggregate_handler, window_handler)
        self.state = state
        self.subquery_handler = subquery_handler

    # change-tracking origin columns (reference stream.rs): NULL until a
    # mutation stamps them; this engine tracks changes via streams, so
    # they are always NULL on base-table reads
    _ORIGIN_COLS = ("_origin_version", "_origin_block_id",
                    "_origin_block_row_num")

    def bind(self, e: A.Expr) -> ScalarExpr:
        if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists)) \
                and self.subquery_handler is not None:
            return self.subquery_handler(e, self)
        if isinstance(e, A.ColumnRef) and e.table is None \
                and e.name.lower() in self._ORIGIN_COLS \
                and not self.ctx.has(e.name):
            info = getattr(self.state, "table_info", None)
            if info is not None and str((info.options or {}).get(
                    "change_tracking", "")).lower() in ("true", "1", "on"):
                from ..types.datatype import NullType as _NT
                return Constant(None, _NT())
        return super().bind(e)

    def _bind_function(self, e: A.FunctionCall) -> ScalarExpr:
        name = e.name.lower()
        if name in _DISTANCE_FNS:
            rewritten = self._try_rewrite_vector(e)
            if rewritten is not None:
                return rewritten
        if name in ("match", "query", "score"):
            return self._bind_search_function(e)
        return super()._bind_function(e)

    # --- KNN rewrite (reference try_rewrite_vector_function) ---------------
    def _try_rewrite_vector(self, e: A.FunctionCall) -> Optional[ScalarExpr]:
        st = self.state
        if st.scan is None or st.vector_rewrite is not None:
            return None
        if len(e.args) != 2:
            return None
        col_ast, const_ast = e.args
        if isinstance(col_ast, A.Literal) and isinstance(const_ast, A.ColumnRef):
            col_ast, const_ast = const_ast, col_ast
        if not (isinstance(col_ast, A.ColumnRef) and isinstance(const_ast, A.Literal)):
            return None
        if not isinstance(const_ast.value, (list, tuple)):
            return None
        try:
            col = self.ctx.resolve(col_ast.name, col_ast.table)
        except Exception:
            return None
        vt = col.dtype.remove_nullable()
        if not isinstance(vt, VectorType):
            return None
        metric = _DISTANCE_FNS[e.name.lower()]
        # a defined VECTOR INDEX with this distance is required for rewrite
        for idx in st.table_info.vector_indexes():
            distances = [m.strip() for m in idx.options.get("distance", "cosine").split(",")]
            if idx.columns[0].lower() == col.name.lower() and metric in distances:
                q = [float(v) for v in const_ast.value]
                if len(q) != vt.dim:
                    raise SemanticError(
                        f"{e.name}: vector dims differ ({vt.dim} vs {len(q)})")
                st.vector_rewrite = VectorIndexInfo(
                    idx.name, col.name, e.name.lower(), q, dict(idx.options))
                return BoundColumn(VECTOR_SCORE_COL_NAME, Float32)
        return None

    # --- search rewrite (reference resolve_*_search_function) --------------
    def _bind_search_function(self, e: A.FunctionCall) -> ScalarExpr:
        st = self.state
        name = e.name.lower()
        if st.scan is None:
            raise SemanticError(f"{name}() requires a single indexed table")
        if name == "score":
            st.used_score_fn = True
            if st.inverted_rewrite is not None:
                st.inverted_rewrite.has_score = True
            return BoundColumn(SEARCH_SCORE_COL_NAME, Float32)
        if not e.args or not isinstance(e.args[-1], A.Literal):
            raise SemanticError(f"{name}() expects a constant query string")
        indexes = st.table_info.inverted_indexes()
        if not indexes:
            raise UnknownIndex(
                f"{name}() requires an INVERTED INDEX on table "
                f"{st.table_info.name!r}")
        if name == "match":
            if len(e.args) < 2:
                raise SemanticError("match() expects (column, query[, options])")
            col_ast = e.args[0]
            cols = [col_ast.name] if isinstance(col_ast, A.ColumnRef) else []
            idx = next((i for i in indexes
                        if not cols or cols[0].lower() in [c.lower() for c in i.columns]),
                       indexes[0])
            query_text = e.args[1].value
            fuzziness, operator = None, "OR"
            if len(e.args) > 2 and isinstance(e.args[2], A.Literal):
                for part in str(e.args[2].value).split(";"):
                    if "=" in part:
                        k, v = part.split("=", 1)
                        if k.strip() == "fuzziness":
                            fuzziness = int(v)
                        elif k.strip() == "operator":
                            operator = v.strip().upper()
            st.inverted_rewrite = InvertedIndexInfo(
                idx.name, [c.lower() for c in idx.columns], str(query_text),
                True, fuzziness, operator, has_score=st.used_score_fn)
        else:  # query('col:foo AND bar'[, 'fuzziness=N'])
            idx = indexes[0]
            fuzziness = None
            if len(e.args) > 1 and isinstance(e.args[1], A.Literal):
                for part in str(e.args[1].value).split(";"):
                    if "=" in part:
                        k, v = part.split("=", 1)
                        if k.strip() == "fuzziness":
                            fuzziness = int(v)
            st.inverted_rewrite = InvertedIndexInfo(
                idx.name, [c.lower() for c in idx.columns],
                str(e.args[0].value), False, fuzziness,
                has_score=st.used_score_fn)
        return BoundColumn(SEARCH_MATCHED_COL_NAME, Boolean)


class Binder:
    def __init__(self, session):
        self.session = session
        # streams read by this query (consumed by a successful DML)
        self.touched_streams: List[Tuple[str, str]] = []

    # ------------------------------------------------------------------ query
    def bind_query(self, q: A.Query,
                   ctes: Optional[Dict[str, Plan]] = None) -> Plan:
        ctes = dict(ctes or {})
        for name, cq in q.ctes:
            if getattr(q, "recursive", False) \
                    and _cte_self_references(cq, name):
                p = self._bind_recursive_cte(name, cq, ctes)
            else:
                p = self.bind_query(cq, ctes)
            cols = getattr(cq, "cte_columns", None)
            if cols:
                # WITH t(a, b) AS (...): rename the leading outputs
                fields = p.output_fields()
                if len(cols) > len(fields):
                    raise SemanticError(
                        f"CTE {name!r} has {len(fields)} columns but "
                        f"{len(cols)} column aliases")
                p = ProjectPlan(p, [
                    (cols[i] if i < len(cols) else f.name,
                     BoundColumn(f.name, f.dtype))
                    for i, f in enumerate(fields)])
            ctes[name.lower()] = p
        if isinstance(q.body, A.SelectStmt):
            return self._bind_select(q.body, q.order_by, q.limit, q.offset, ctes)
        if isinstance(q.body, A.SetOp):
            plan = self._bind_setop(q.body, ctes)
            plan = self._order_limit_over(plan, q)
            return plan
        if isinstance(q.body, A.Query):
            plan = self.bind_query(q.body, ctes)
            return self._order_limit_over(plan, q)
        raise SemanticError(f"unsupported query body {type(q.body).__name__}")

    def _order_limit_over(self, plan: Plan, q: A.Query) -> Plan:
        if q.order_by:
            fields = plan.output_fields()
            names = {f.name.lower() for f in fields}
            items = []
            for ob in q.order_by:
                if isinstance(ob.expr, A.Literal) \
                        and isinstance(ob.expr.value, int) \
                        and 1 <= ob.expr.value <= len(fields):
                    items.append(SortItem(fields[ob.expr.value - 1].name,
                                          ob.asc, ob.nulls_first))
                elif isinstance(ob.expr, A.ColumnRef) and ob.expr.name.lower() in names:
                    items.append(SortItem(ob.expr.name, ob.asc, ob.nulls_first))
                else:
                    raise SemanticError("ORDER BY over set operations must reference output columns")
            plan = SortPlan(plan, items, _limit_value(q))
        if q.limit is not None or q.offset is not None:
            plan = LimitPlan(plan, _const_int(q.limit), _const_int(q.offset) or 0)
        return plan

    def _bind_recursive_cte(self, name: str, cq: A.Query, ctes) -> Plan:
        """WITH RECURSIVE r AS (anchor UNION ALL step) — iterate the step
        against the previous iteration's rows until fixpoint (reference:
        recursive CTE binding/execution; r_cte union semantics). Runs at
        bind time, like stage scans — the result is a ValuesPlan."""
        from ..pipeline.executor import execute_plan
        body = cq.body
        if not isinstance(body, A.SetOp) or not body.op.startswith("UNION"):
            raise SemanticError(
                "recursive CTE must be 'anchor UNION [ALL] step'")
        distinct = body.op == "UNION"
        anchor_plan = self._bind_body(body.left, ctes)
        fields = anchor_plan.output_fields()
        cols = getattr(cq, "cte_columns", None)
        if cols:
            # WITH RECURSIVE r(a, b) AS (...): the step subquery sees the
            # renamed columns, so rename before iterating
            if len(cols) > len(fields):
                raise SemanticError(
                    f"recursive CTE {name!r} has {len(fields)} columns "
                    f"but {len(cols)} column aliases")
            fields = [DataField(cols[i] if i < len(cols) else f.name,
                                f.dtype) for i, f in enumerate(fields)]
        names = [f.name for f in fields]
        cur = execute_plan(anchor_plan)
        if cols:
            cur = DataBlock(names, list(cur.columns), cur.num_rows)
        max_depth = 512
        try:
            from ..utils.current import current_session
            s = current_session()
            if s is not None:
                max_depth = int(s.settings.get(
                    "max_cte_recursive_depth") or 512)
        except Exception:
            pass
        chunks = [cur]
        seen = None
        if distinct:
            from ..pipeline.keys import hashable_row
            seen = {hashable_row(list(cur.columns), i)
                    for i in range(cur.num_rows)}
        for _ in range(max_depth):
            if cur.num_rows == 0:
                break
            step_ctes = dict(ctes)
            step_ctes[name.lower()] = ValuesPlan(
                DataBlock(names, list(cur.columns), cur.num_rows),
                list(fields))
            step_plan = self._bind_body(body.right, step_ctes)
            nxt = execute_plan(step_plan)
            if nxt.num_columns() != len(names):
                raise SemanticError("recursive step arity mismatch")
            nxt = DataBlock(names, list(nxt.columns), nxt.num_rows)
            if distinct and nxt.num_rows:
                import numpy as np
                from ..pipeline.keys import hashable_row
                cols = list(nxt.columns)
                keep = np.zeros(nxt.num_rows, np.bool_)
                for i in range(nxt.num_rows):
                    k = hashable_row(cols, i)
                    if k not in seen:
                        seen.add(k)
                        keep[i] = True
                nxt = nxt.filter(keep)
            cur = nxt
            if cur.num_rows:
                chunks.append(cur)
            else:
                break  # fixpoint reached on the last allowed step
        else:
            raise SemanticError(
                f"recursive CTE {name!r} exceeded max depth {max_depth}")
        return ValuesPlan(DataBlock.concat(chunks), list(fields))

    def _bind_setop(self, s: A.SetOp, ctes) -> Plan:
        left = self._bind_body(s.left, ctes)
        right = self._bind_body(s.right, ctes)
        lf, rf = left.output_fields(), right.output_fields()
        if len(lf) != len(rf):
            raise SemanticError("UNION inputs must have the same number of columns")
        # unify column types across the arms (reference: set-op type
        # unification in the type checker — NULL literals, decimal+float,
        # int widths all settle on the common super type)
        from ..types import common_super_type
        targets = []
        for i in range(len(lf)):
            try:
                targets.append(common_super_type(lf[i].dtype, rf[i].dtype))
            except Exception:
                targets.append(lf[i].dtype)
        from ..expression.expr import CastExpr

        def _aligned(plan, fields, out_names):
            items, changed = [], False
            for i, f in enumerate(fields):
                e: ScalarExpr = BoundColumn(f.name, f.dtype)
                if f.dtype != targets[i]:
                    e = CastExpr(e, targets[i], False)
                    changed = True
                if f.name != out_names[i]:
                    changed = True
                items.append((out_names[i], e))
            return ProjectPlan(plan, items) if changed else plan

        names = [f.name for f in lf]
        left = _aligned(left, lf, names)
        right = _aligned(right, rf, names)
        if s.op == "UNION ALL":
            return UnionAllPlan([left, right])
        if s.op == "UNION":
            return DistinctPlan(UnionAllPlan([left, right]))
        if s.op in ("INTERSECT", "EXCEPT", "INTERSECT ALL", "EXCEPT ALL"):
            from .plans import SetOpPlan
            return SetOpPlan(s.op, left, right)
        raise SemanticError(f"set operation {s.op} not supported yet")

    def _bind_body(self, body, ctes) -> Plan:
        if isinstance(body, A.SelectStmt):
            return self._bind_select(body, [], None, None, ctes)
        if isinstance(body, A.SetOp):
            return self._bind_setop(body, ctes)
        if isinstance(body, A.Query):
            return self.bind_query(body, ctes)
        raise SemanticError("unsupported set operand")

    # ---------------------------------------------------- grouping sets
    def _bind_grouping_sets(self, sel: A.SelectStmt, order_by, limit,
                            offset, ctes) -> Plan:
        """GROUP BY GROUPING SETS/CUBE/ROLLUP -> UNION ALL of per-set
        aggregates with NULL-filled absent grouping columns and grouping()
        folded per branch (reference: grouping-sets expansion in the
        binder, grouping_sets_to_union)."""
        import copy as _copy
        all_keys = {repr(e) for s in sel.group_sets for e in s}

        import dataclasses as _dc

        def subst(e, absent):
            if isinstance(e, A.FunctionCall):
                name = e.name.lower()
                if is_aggregate_function(name):
                    return e  # aggregate args see the real rows
                if name == "grouping" and len(e.args) == 1:
                    return A.Literal(1 if repr(e.args[0]) in absent else 0)
                e2 = _copy.copy(e)
                e2.args = [subst(a, absent) for a in e.args]
                if e2.window is not None:   # grouping() in OVER (q70/q86)
                    w = _copy.copy(e2.window)
                    if getattr(w, "partition_by", None):
                        w.partition_by = [subst(x, absent)
                                          for x in w.partition_by]
                    if getattr(w, "order_by", None):
                        ob = []
                        for o in w.order_by:
                            o2 = _copy.copy(o)
                            o2.expr = subst(o2.expr, absent)
                            ob.append(o2)
                        w.order_by = ob
                    e2.window = w
                return e2
            if repr(e) in absent:
                return A.Literal(None)
            # generic dataclass walk (covers CASE condition/result lists,
            # BETWEEN bounds, IN lists, ...)
            if _dc.is_dataclass(e) and isinstance(e, A.Expr) \
                    and not isinstance(e, A.Query):
                e = _copy.copy(e)
                for f in _dc.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, A.Expr):
                        setattr(e, f.name, subst(v, absent))
                    elif isinstance(v, list) and any(
                            isinstance(x, A.Expr) for x in v):
                        setattr(e, f.name,
                                [subst(x, absent) if isinstance(x, A.Expr)
                                 else x for x in v])
            return e

        # ORDER BY expressions that aren't plain output references (e.g.
        # `CASE WHEN grouping(a)=0 THEN a END`, q70/q86) ride as hidden
        # select items so grouping() folds per branch; projected away after
        # the sort.
        n_visible = len(sel.items)
        sel_items = list(sel.items)
        ob_hidden: list = []
        for i, ob in enumerate(order_by or []):
            if isinstance(ob.expr, A.ColumnRef):
                ob_hidden.append(None)
            else:
                name = f"__gsob{i}"
                sel_items.append(A.SelectItem(ob.expr, name))
                ob_hidden.append(name)

        plans = []
        for gset in sel.group_sets:
            present = {repr(e) for e in gset}
            absent = all_keys - present
            items = []
            for i, it in enumerate(sel_items):
                new_expr = subst(it.expr, absent)
                # NULL-substituted items keep their original output name so
                # every branch's columns line up for the UNION
                alias = it.alias or _suggest_name(it.expr) or f"col_{i}"
                items.append(A.SelectItem(new_expr, alias))
            branch = A.SelectStmt(
                items, sel.from_, sel.where, list(gset),
                subst(sel.having, absent) if sel.having is not None else None,
                sel.distinct)
            plans.append(self._bind_select(branch, [], None, None, ctes))
        # unify column types across branches (NULL-filled columns bind as
        # NullType; cast them to the first concrete dtype seen)
        n_cols = len(plans[0].output_fields())
        from ..types.datatype import NullType
        targets = []
        for i in range(n_cols):
            dt = next((p.output_fields()[i].dtype for p in plans
                       if not isinstance(p.output_fields()[i].dtype
                                         .remove_nullable(), NullType)),
                      plans[0].output_fields()[i].dtype)
            targets.append(dt.wrap_nullable())
        names = [f.name for f in plans[0].output_fields()]
        aligned = []
        for p in plans:
            items = []
            for i, f in enumerate(p.output_fields()):
                e = BoundColumn(f.name, f.dtype)
                if f.dtype != targets[i]:
                    e = CastExpr(e, targets[i], False)
                items.append((names[i], e))
            aligned.append(ProjectPlan(p, items))
        plan = UnionAllPlan(aligned)
        if order_by:
            out_names = {f.name.lower() for f in plan.output_fields()}
            items = []
            for ob, hname in zip(order_by, ob_hidden):
                if hname is not None:
                    items.append(SortItem(hname, ob.asc, ob.nulls_first))
                elif ob.expr.name.lower() in out_names:
                    items.append(SortItem(ob.expr.name, ob.asc, ob.nulls_first))
                else:
                    raise SemanticError(
                        "ORDER BY over GROUPING SETS must reference output"
                        " columns")
            plan = SortPlan(plan, items)
            if any(h is not None for h in ob_hidden):
                fields = plan.output_fields()[:n_visible]
                plan = ProjectPlan(plan, [
                    (f.name, BoundColumn(f.name, f.dtype)) for f in fields])
        if limit is not None or offset is not None:
            plan = LimitPlan(plan, _const_int(limit), _const_int(offset) or 0)
        return plan

    # ----------------------------------------------------------------- select
    def _bind_select(self, sel: A.SelectStmt, order_by: List[A.OrderByExpr],
                     limit, offset, ctes) -> Plan:
        if sel.group_sets is not None:
            return self._bind_grouping_sets(sel, order_by, limit, offset, ctes)
        # correlated [NOT] EXISTS / IN conjuncts -> SEMI/ANTI joins
        # (reference: subquery decorrelation rules in the optimizer)
        from .decorrelate import decorrelate_where, rewrite_any_all
        sel.where = rewrite_any_all(sel.where)
        if sel.having is not None:
            sel.having = rewrite_any_all(sel.having)
        cte_names = {n.lower() for n in (ctes or {})}

        def _resolver(ref):
            """Table columns for decorrelation; None when unknown (CTE,
            view, missing) — falls back to qualified-only detection."""
            name = getattr(ref, "name", None)
            if name is None or name.lower() in cte_names:
                return None
            try:
                t = self.session.table(name, getattr(ref, "database", None))
                return {f.name.lower() for f in t.schema.fields}
            except Exception:
                return None

        decorrelate_where(sel, getattr(self, "_decorr_counter", None)
                          or self.__dict__.setdefault("_decorr_counter", [0]),
                          _resolver)
        state = ScanState()
        if sel.from_ is None:
            plan, ctx = self._one_row_plan()
        else:
            plan, ctx = self._bind_table_ref(sel.from_, ctes, state)

        aggs: List[Tuple[str, object, List[ScalarExpr]]] = []
        agg_asts: List[str] = []

        def agg_handler(e: A.FunctionCall):
            # count(*) has no args to bind
            arg_exprs = []
            if not (e.name.lower() == "count" and
                    (not e.args or isinstance(e.args[0], A.Star))):
                arg_exprs = [base_binder.bind(a) for a in e.args]
                # sum(NULL)/min(NULL)/... : the NULL literal aggregates
                # as a nullable int column of NULLs (reference:
                # 03_0001_select_aggregator NULL rows)
                from ..types.datatype import NullType
                arg_exprs = [Constant(None, Int64.wrap_nullable())
                             if isinstance(a.dtype.remove_nullable(),
                                           NullType) else a
                             for a in arg_exprs]
            fn = create_aggregate(e.name, [a.dtype for a in arg_exprs], e.distinct)
            key = _ast_repr(e)
            for i, existing in enumerate(agg_asts):
                if existing == key:
                    return BoundColumn(f"__agg_{i}", aggs[i][1].return_type().wrap_nullable())
            name = f"__agg_{len(aggs)}"
            aggs.append((name, fn, arg_exprs))
            agg_asts.append(key)
            rt = fn.return_type()
            return BoundColumn(name, rt if fn.name.startswith("count") else rt.wrap_nullable())

        def subquery_handler(e, binder):
            return self._bind_subquery_expr(e, binder, ctes)

        windows: List[WindowItem] = []
        window_asts: List[str] = []

        def window_handler(e: A.FunctionCall):
            name = e.name.lower()
            w = e.window
            key = (_ast_repr(e)
                   + "|part:" + ",".join(_ast_repr(p) for p in w.partition_by)
                   + "|ord:" + ",".join(f"{_ast_repr(ob.expr)}:{ob.asc}:{ob.nulls_first}"
                                        for ob in w.order_by)
                   + f"|frame:{w.frame}:{w.frame_kind}")
            for i, existing in enumerate(window_asts):
                if existing == key:
                    return BoundColumn(windows[i].out_name, windows[i].dtype)
            if name not in _WINDOW_ONLY_FNS and not is_aggregate_function(name):
                raise SemanticError(f"{name}() is not a window function")
            if e.distinct:
                raise SemanticError("DISTINCT is not supported in window functions")
            arg_asts = e.args
            if name == "count" and arg_asts and isinstance(arg_asts[0], A.Star):
                arg_asts = []  # count(*) over (...)
            arg_exprs = [base_binder.bind(a) for a in arg_asts]
            part = [base_binder.bind(p) for p in e.window.partition_by]
            order = [(base_binder.bind(ob.expr), ob.asc, ob.nulls_first)
                     for ob in e.window.order_by]
            dtype = _window_return_type(name, arg_exprs)
            out = f"__win_{len(windows)}"
            windows.append(WindowItem(out, name, arg_exprs, part, order, dtype,
                                      frame=w.frame, frame_kind=w.frame_kind))
            window_asts.append(key)
            return BoundColumn(out, dtype)

        base_binder = SelectExprBinder(ctx, state, agg_handler, subquery_handler,
                                       window_handler)

        # WHERE -------------------------------------------------------------
        where_expr = None
        if sel.where is not None:
            # select-item aliases are visible in WHERE (reference dialect:
            # `SELECT dist(x) AS s .. WHERE s > 0.1`, 09_vector_index
            # suite); substitute only names that do NOT resolve as columns
            where_ast = self._substitute_where_aliases(sel.where, sel.items,
                                                       ctx)
            no_agg_binder = SelectExprBinder(ctx, state, None, subquery_handler)
            where_expr = no_agg_binder.bind(where_ast)
            if state.scan is not None:
                state.scan.pushdown.filters = where_expr
            else:
                plan = FilterPlan(plan, where_expr)

        # GROUP BY / aggregates ----------------------------------------------
        select_items = self._expand_stars(sel.items, ctx)
        group_by_exprs = list(sel.group_by)
        if sel.group_all:
            # GROUP BY ALL: every select item without an aggregate becomes
            # a grouping key (reference: group-by-all desugar in the binder)
            group_by_exprs = [it.expr for it in select_items
                              if not _contains_aggregate(it.expr)]
            if not group_by_exprs:
                raise SemanticError("GROUP BY ALL needs at least one"
                                    " non-aggregate select item")
        group_keys: List[Tuple[str, ScalarExpr]] = []
        group_key_asts: List[str] = []
        for g in group_by_exprs:
            if isinstance(g, A.Literal) and isinstance(g.value, int):
                item = select_items[g.value - 1]
                g = item.expr
            elif isinstance(g, A.ColumnRef) and g.table is None:
                # GROUP BY <select alias> — the alias wins over a
                # same-named source column (reference semantics:
                # `SELECT number % 3 AS number ... GROUP BY number`
                # groups by the alias, base/03_0003_select_group_by)
                for item in select_items:
                    if item.alias and item.alias.lower() == g.name.lower():
                        g = item.expr
                        break
                else:
                    if not ctx.has(g.name):
                        pass  # unresolved: surfaces as bind error below
            if _contains_aggregate(g):
                raise SemanticError(
                    "GROUP BY items can't contain aggregate functions or "
                    "window functions")
            kb = SelectExprBinder(ctx, state, None, subquery_handler)
            ge = kb.bind(g)
            name = _suggest_name(g) or f"__key_{len(group_keys)}"
            if any(n == name for n, _ in group_keys):
                # same bare column name from different aliases (GROUP BY
                # d1.d_year, d2.d_year, TPC-DS q64): keep keys distinct
                name = f"{name}__k{len(group_keys)}"
            group_keys.append((name, ge))
            group_key_asts.append(_ast_repr(g))

        # bind select items (fills `aggs` through the handler)
        bound_items: List[Tuple[str, ScalarExpr]] = []
        for item in select_items:
            name = item.alias or _suggest_name(item.expr) or f"col_{len(bound_items)}"
            expr_ast = item.expr
            if isinstance(expr_ast, A.ColumnRef) and expr_ast.table is None \
                    and item.alias and item.alias.lower() \
                    == expr_ast.name.lower():
                pass  # `x AS x` never substitutes itself
            else:
                # sibling select aliases are visible in later items
                # (reference: `sum(a) s, sum(b) t, s + t`,
                # 03_0007_select_alias)
                others = [it for it in select_items
                          if it is not item and it.alias]
                expr_ast = self._substitute_where_aliases(expr_ast, others,
                                                          ctx)
            e = self._bind_with_group_rewrite(expr_ast, base_binder,
                                              group_key_asts, group_keys)
            bound_items.append((name, e))

        having_expr = None
        if sel.having is not None:
            # select aliases are visible in HAVING (`SELECT MAX(n) AS m
            # ... HAVING m > 8`, reference 03_0006_select_having); window
            # functions are not allowed there
            having_ast = self._substitute_where_aliases(sel.having,
                                                        sel.items, ctx)
            if _contains_window(having_ast):
                raise SemanticError(
                    "window functions are not allowed in HAVING")
            having_expr = self._bind_with_group_rewrite(
                having_ast, base_binder, group_key_asts, group_keys)

        # ORDER BY (bind before deciding aggregation so agg refs register)
        sort_items: List[SortItem] = []
        extra_items: List[Tuple[str, ScalarExpr]] = []
        for i, ob in enumerate(order_by or []):
            target = ob.expr
            if isinstance(target, A.Literal) and isinstance(target.value, int):
                if not 1 <= target.value <= len(bound_items):
                    raise SemanticError(
                        f"ORDER BY position {target.value} is not in "
                        f"select list")
                name = bound_items[target.value - 1][0]
                sort_items.append(SortItem(name, ob.asc, ob.nulls_first))
                continue
            alias_hit = None
            if isinstance(target, A.ColumnRef) and target.table is None:
                for n, _ in bound_items:
                    if n.lower() == target.name.lower():
                        alias_hit = n
                        break
            if alias_hit is not None:
                sort_items.append(SortItem(alias_hit, ob.asc, ob.nulls_first))
                continue
            e = self._bind_with_group_rewrite(target, base_binder,
                                              group_key_asts, group_keys)
            # reuse an identical select item if present (only when its
            # output name is unambiguous — duplicate select names would
            # make the sort read the wrong column)
            same = next((n for n, be in bound_items if _expr_eq(be, e)), None)
            if same is not None and sum(1 for n, _ in bound_items
                                        if n == same) == 1:
                sort_items.append(SortItem(same, ob.asc, ob.nulls_first))
            else:
                name = f"__sort_{i}"
                extra_items.append((name, e))
                sort_items.append(SortItem(name, ob.asc, ob.nulls_first))

        # QUALIFY ------------------------------------------------------------
        # filter over window results (reference QUALIFY clause): evaluated
        # after windows + projection, over select aliases, window outputs,
        # and hidden passthrough columns
        qualify_expr = None
        qualify_hidden: List[Tuple[str, ScalarExpr]] = []
        if sel.qualify is not None:
            win_map: Dict[int, ScalarExpr] = {}
            alias_names = {n.lower() for n, _ in bound_items}
            qctx = BindContext()
            for n, be in bound_items:
                qctx.add(n, be.dtype, None)

            def collect(e):
                if isinstance(e, A.FunctionCall) and e.window is not None:
                    be = base_binder.bind(e)  # registers the window item
                    win_map[id(e)] = be
                    if not any(n == be.name for n, _ in qualify_hidden):
                        qualify_hidden.append(
                            (be.name, BoundColumn(be.name, be.dtype)))
                    return
                if isinstance(e, A.ColumnRef):
                    if e.table is None and e.name.lower() in alias_names:
                        return
                    be = self._bind_with_group_rewrite(
                        e, base_binder, group_key_asts, group_keys)
                    hname = f"__q_{len(qualify_hidden)}"
                    qualify_hidden.append((hname, be))
                    qctx.add(e.name, be.dtype, e.table, hname)
                    return
                for child in _ast_children(e):
                    collect(child)

            collect(sel.qualify)
            for n, be in qualify_hidden:
                if n.startswith("__win_"):
                    qctx.add(n, be.dtype, None)
            q_binder = ExprBinder(qctx, None,
                                  window_handler=lambda e: win_map[id(e)])
            qualify_expr = q_binder.bind(sel.qualify)

        has_agg = bool(aggs) or bool(group_by_exprs)
        if has_agg:
            # every select/order item must reduce to group keys, aggregate
            # outputs or window outputs (reference bind error; a stray
            # column would otherwise fail deep in the executor)
            from ..expression.expr import BoundColumn as _BC
            allowed = {n.lower() for n, _ in group_keys}
            allowed.update(n.lower() for n, _, _ in aggs)
            allowed.update(w.out_name.lower() for w in windows)
            checked = bound_items + extra_items
            if having_expr is not None:
                checked = checked + [("__having", having_expr)]
            for w in windows:
                # window partition/order keys run over the aggregate's
                # output and must reduce to it as well
                checked = checked + \
                    [("__win_part", e) for e in w.partition_by] + \
                    [("__win_ord", e) for e, _, _ in w.order_by]
            for iname, be in checked:
                for node in be.walk():
                    if isinstance(node, _BC) \
                            and node.name.lower() not in allowed \
                            and not node.name.startswith("__"):
                        raise SemanticError(
                            f"column {node.name!r} must appear in the "
                            f"GROUP BY clause or be used in an aggregate "
                            f"function")
            plan = AggregatePlan(plan, group_keys, aggs,
                                 distributed=self._distributed_on(),
                                 spill_threshold_rows=self._spill_rows(
                                     "aggregate_spill_row_threshold"),
                                 stats_fast_path=self._setting_bool(
                                     "enable_aggregating_index_scan", True))
            if having_expr is not None:
                plan = FilterPlan(plan, having_expr)
        elif having_expr is not None:
            # HAVING without aggregation filters plain rows (reference
            # dialect: `SELECT * FROM numbers(3) HAVING number > 1`)
            plan = FilterPlan(plan, having_expr)

        if windows:
            plan = WindowPlan(plan, windows,
                              distributed=self._distributed_on())

        # finalize scan pushdowns (vector/search rewrites recorded during
        # binds). LIMIT/TopN pushdown is only sound when no row-collapsing
        # operator sits between the scan and the sort: an aggregate,
        # window or DISTINCT consumes EVERY row, so pruning scan blocks
        # by the limit corrupts its result (reference: push_down_limit.rs
        # stops at Aggregate/Window boundaries).
        blocks_limit = has_agg or bool(windows) or sel.distinct \
            or qualify_expr is not None
        self._finalize_scan(state, where_expr,
                            [] if blocks_limit else sort_items,
                            None if blocks_limit else limit,
                            bound_items + extra_items)

        # projection (+ hidden sort keys + hidden qualify columns).
        # Duplicate output names (SELECT t0.c, t1.c) get unique physical
        # names so by-name lookups downstream (sort keys, the final
        # unwrap projection) can't silently read the wrong column; the
        # final projection restores the display names.
        phys_items: List[Tuple[str, ScalarExpr]] = []
        restore: List[Tuple[str, str]] = []  # (display, physical)
        seen_names: Dict[str, int] = {}
        for n, e in bound_items:
            k = n.lower()
            if k in seen_names:
                pn = f"{n}__dup{seen_names[k]}"
                seen_names[k] += 1
            else:
                pn = n
                seen_names[k] = 1
            phys_items.append((pn, e))
            restore.append((n, pn))
        renamed = any(n != pn for n, pn in restore)
        plan = ProjectPlan(plan, phys_items + extra_items + qualify_hidden)
        if qualify_expr is not None:
            plan = FilterPlan(plan, qualify_expr)
        if sel.distinct:
            if extra_items:
                raise SemanticError("ORDER BY expressions must appear in SELECT DISTINCT items")
            plan = DistinctPlan(plan)
        if sort_items:
            spill_rows = None
            try:
                spill_rows = int(self.session.settings.get("sort_spill_row_threshold")) or None
            except Exception:
                pass
            plan = SortPlan(plan, sort_items, _limit_sum(limit, offset),
                            spill_threshold_rows=spill_rows,
                            distributed=self._distributed_on())
        if extra_items or qualify_hidden or renamed:
            plan = ProjectPlan(plan, [
                (n, BoundColumn(pn, e.dtype))
                for (n, pn), (_, e) in zip(restore, bound_items)])
        if limit is not None or offset is not None:
            plan = LimitPlan(plan, _const_int(limit), _const_int(offset) or 0)
        return plan

    # -------------------------------------------------------------- from refs
    def _one_row_plan(self):
        import numpy as np
        from ..expression import Column
        block = DataBlock(["__dummy"], [Column.from_numpy(np.zeros(1, np.int8))])
        return ValuesPlan(block, [DataField("__dummy", Int64)]), BindContext()

    def _bind_table_ref(self, ref: A.TableRef, ctes, state: ScanState):
        plan, ctx = self._bind_table_ref_inner(ref, ctes, state)
        if isinstance(ref, A.TableName) and ref.alias is None:
            db = (ref.database or self.session.current_database).lower()
            ctx.db_quals.add((db, ref.name.lower()))
        cols = getattr(ref, "column_aliases", None)
        if cols:
            # t AS a(x, y): rename the leading output columns
            fields = plan.output_fields()
            if len(cols) > len(fields):
                raise SemanticError(
                    f"table alias has {len(fields)} columns available "
                    f"but {len(cols)} columns specified")
            items = [(cols[i] if i < len(cols) else f.name,
                      BoundColumn(f.name, f.dtype))
                     for i, f in enumerate(fields)]
            plan = ProjectPlan(plan, items)
            alias = getattr(ref, "alias", None)
            ctx = BindContext()
            for n, e in items:
                ctx.add(n, e.dtype, alias)
            state.scan = None
            state.table_info = None
        return plan, ctx

    def _bind_table_ref_inner(self, ref: A.TableRef, ctes,
                              state: ScanState):
        if isinstance(ref, A.TableName):
            if ref.catalog is not None \
                    and ref.catalog.lower() != "default":
                # catalog.db.table through a registered external catalog
                # (reference CatalogManager multi-catalog resolution)
                t = self.session.catalog_table(ref.catalog, ref.database,
                                               ref.name)
                scan = Scan(t, PushDownInfo())
                ctx = BindContext()
                alias = ref.alias or ref.name
                for f in t.info.schema.fields:
                    ctx.add(f.name, f.dtype, alias)
                if state.scan is None and state.table_info is None:
                    state.scan = scan
                    state.table_info = t.info
                else:
                    state.scan = None
                    state.table_info = None
                return scan, ctx
            key = ref.name.lower()
            if ref.database is None and key in ctes:
                # each use gets its own plan-node copy: the optimizer
                # mutates Scan pushdowns, and two branches filtering the
                # same CTE must not push conflicting filters into one
                # shared Scan (reference: CTEs re-bind per consumer)
                sub = _clone_plan(ctes[key])
                ctx = BindContext()
                alias = ref.alias or ref.name
                for f in sub.output_fields():
                    ctx.add(f.name, f.dtype, alias)
                return sub, ctx
            db = ref.database or self.session.current_database
            if db.lower() == "information_schema":
                # ANSI compatibility schema: aliases onto system.* tables
                alias_map = {"tables": "tables", "columns": "columns",
                             "schemata": "databases", "views": "tables",
                             "keywords": "functions"}
                db = "system"
                ref = A.TableName(alias_map.get(ref.name.lower(), ref.name),
                                  "system", ref.alias, ref.at_snapshot)
            # session temp tables shadow the shared catalog
            temp = self.session.temp_table(db, ref.name) \
                if hasattr(self.session, "temp_table") else None
            if temp is not None:
                scan = Scan(temp, PushDownInfo(), snapshot_id=ref.at_snapshot)
                ctx = BindContext()
                alias = ref.alias or ref.name
                for f in temp.info.schema.fields:
                    ctx.add(f.name, f.dtype, alias)
                if state.scan is None and state.table_info is None:
                    state.scan = scan
                    state.table_info = temp.info
                else:
                    state.scan = None
                    state.table_info = None
                return scan, ctx
            if db.lower() == "system":
                from ..service.system_tables import system_table_plan
                plan = system_table_plan(self.session, ref.name)
                ctx = BindContext()
                for f in plan.output_fields():
                    ctx.add(f.name, f.dtype, ref.alias or ref.name)
                state.scan = None
                state.table_info = None
                return plan, ctx
            # views expand to their stored query (bound as a subquery)
            view, _ = self.session.meta.get(
                f"views/{db.lower()}/{ref.name.lower()}")
            if view is not None:
                self._view_depth = getattr(self, "_view_depth", 0) + 1
                if self._view_depth > 16:
                    raise SemanticError(
                        f"view {ref.name!r} expansion too deep (recursive?)")
                from .parser import Parser
                try:
                    sub = self.bind_query(Parser(view["query_text"]).parse_query(),
                                          ctes)
                finally:
                    self._view_depth -= 1
                ctx = BindContext()
                alias = ref.alias or ref.name
                for f in sub.output_fields():
                    ctx.add(f.name, f.dtype, alias)
                state.scan = None
                state.table_info = None
                return sub, ctx
            # streams shadow tables of the same name only if no table exists
            stream_info = self.session.streams.get(db, ref.name) \
                if hasattr(self.session, "streams") else None
            if stream_info is not None:
                self.session.check_privilege(
                    "SELECT", stream_info["table_database"],
                    stream_info["table_name"])
                block, fields = self.session.streams.read_delta(db, ref.name)
                self.touched_streams.append((db, ref.name))
                plan = ValuesPlan(block, fields)
                ctx = BindContext()
                alias = ref.alias or ref.name
                for f in fields:
                    ctx.add(f.name, f.dtype, alias)
                state.scan = None
                state.table_info = None
                return plan, ctx
            self.session.check_privilege("SELECT", db, ref.name)
            info = self.session.catalog.get_table(db, ref.name)
            table = self.session.open_table(info)
            scan = Scan(table, PushDownInfo(), snapshot_id=ref.at_snapshot)
            ctx = BindContext()
            alias = ref.alias or ref.name
            for f in info.schema.fields:
                ctx.add(f.name, f.dtype, alias)
            # EE virtual columns: register this snapshot's extracted
            # variant paths so get()/['k'] chains rewrite to the sidecar
            # column (reference binder/virtual_column.rs)
            try:
                snap = table.read_snapshot(ref.at_snapshot)
                if snap is not None and snap.virtual_columns:
                    for vname, m in snap.virtual_columns.items():
                        ctx.virtual_map[(alias.lower(), m["source"].lower(),
                                         tuple(m["path"]))] = (vname, scan)
            except Exception:
                pass
            policied = self._apply_policies(info, scan, ctx)
            if policied is not None:
                state.scan = None
                state.table_info = None
                return policied, ctx
            if state.scan is None and state.table_info is None:
                state.scan = scan
                state.table_info = info
            else:  # joins: no single-scan rewrites
                state.scan = None
                state.table_info = None
            return scan, ctx
        if isinstance(ref, A.SubqueryRef):
            sub = self.bind_query(ref.query, ctes)
            ctx = BindContext()
            for f in sub.output_fields():
                ctx.add(f.name, f.dtype, ref.alias)
            state.scan = None
            state.table_info = None
            return sub, ctx
        if isinstance(ref, A.TableFunctionRef):
            return self._bind_table_function(ref, state)
        if isinstance(ref, A.StageRef):
            import os as _os
            block, fields = self.session.stages.scan_block(
                ref.ref, ref.options,
                _os.path.join(self.session.data_root, "scratch"))
            ctx = BindContext()
            alias = ref.alias or ref.ref.lstrip("@").split("/")[0]
            for f in fields:
                ctx.add(f.name, f.dtype, alias)
            state.scan = None
            state.table_info = None
            return ValuesPlan(block, list(fields)), ctx
        if isinstance(ref, A.ValuesRef):
            # FROM (VALUES ...) — evaluate constant rows into one block
            from ..expression import Column
            from ..expression.evaluator import infer_literal_type
            n_cols = len(ref.rows[0]) if ref.rows else 0
            for row in ref.rows:
                if len(row) != n_cols:
                    raise SemanticError(
                        f"VALUES lists must all be the same length: "
                        f"expected {n_cols} columns, got {len(row)}")
            cols = []
            names = (ref.column_names
                     or [f"col{i}" for i in range(n_cols)])
            if len(names) > n_cols:
                raise SemanticError(
                    f"table alias has {n_cols} columns available but "
                    f"{len(names)} columns specified")
            if len(names) < n_cols:
                names = list(names) + [f"col{i}"
                                       for i in range(len(names), n_cols)]

            def cell(e):
                if isinstance(e, A.UnaryOp) and e.op == "-" \
                        and isinstance(e.operand, A.Literal):
                    return -e.operand.value
                if isinstance(e, A.Literal):
                    return e.value
                # constant expression: fold through the evaluator
                try:
                    be = ExprBinder(BindContext()).bind(e)
                    from ..expression import Column as _C
                    from ..expression.evaluator import Evaluator as _E
                    import numpy as _np
                    blk = DataBlock(["__one"],
                                    [_C.from_numpy(_np.zeros(1, _np.int8))],
                                    1)
                    return _E(blk).run(be).to_pylist()[0]
                except SemanticError:
                    raise
                except Exception:
                    raise SemanticError(
                        "VALUES rows must be constant expressions")

            def family(v):
                if isinstance(v, bool):
                    return "bool"
                if isinstance(v, (int, float)):
                    return "num"
                if isinstance(v, str):
                    return "str"
                if isinstance(v, (list, tuple)):
                    return "array"
                return type(v).__name__

            for ci in range(n_cols):
                vals = [cell(row[ci]) for row in ref.rows]
                fams = {family(v) for v in vals if v is not None}
                if len(fams) > 1:
                    raise SemanticError(
                        f"VALUES column {ci} mixes incompatible types "
                        f"{sorted(fams)}")
                dtype = next((infer_literal_type(v) for v in vals
                              if v is not None), Int64)
                if any(isinstance(v, float) for v in vals):
                    dtype = Float64
                if any(v is None for v in vals):
                    dtype = dtype.wrap_nullable()
                cols.append(Column.from_pylist(vals, dtype))
            block = DataBlock(names, cols, len(ref.rows))
            plan = ValuesPlan(block, [DataField(n, c.dtype)
                                      for n, c in zip(names, cols)])
            ctx = BindContext()
            for n, c in zip(names, cols):
                ctx.add(n, c.dtype, ref.alias)
            state.scan = None
            state.table_info = None
            return plan, ctx
        if isinstance(ref, A.Join):
            return self._bind_join(ref, ctes, state)
        if isinstance(ref, A.PivotRef):
            return self._bind_pivot(ref, ctes)
        if isinstance(ref, A.UnpivotRef):
            return self._bind_unpivot(ref, ctes)
        raise SemanticError(f"unsupported table reference {type(ref).__name__}")

    def _bind_lateral_project(self, j: A.Join, ctes, state: ScanState):
        """t, LATERAL (SELECT <exprs over t> [WHERE ..]) x — a FROM-less
        lateral derived table is a per-row projection over the outer side
        (reference: lateral derived tables in the binder)."""
        left, lctx = self._bind_table_ref(j.left, ctes, ScanState())
        state.scan = None
        state.table_info = None
        sel = j.right.query.body
        alias = j.right.alias or "lateral"
        eb = ExprBinder(lctx)
        items = [(f.name, BoundColumn(f.name, f.dtype))
                 for f in left.output_fields()]
        lnames = {n.lower() for n, _ in items}
        ctx = BindContext()
        for (n, t, tb, on) in lctx.columns:
            ctx.add(n, t, tb, on)
        for i, it in enumerate(sel.items):
            e = eb.bind(it.expr)
            name = it.alias or _suggest_name(it.expr) or f"col_{i}"
            uniq = f"{alias}.{name}" if name.lower() in lnames else name
            items.append((uniq, e))
            ctx.add(name, e.dtype, alias, uniq)
        plan = ProjectPlan(left, items)
        if sel.where is not None:
            plan = FilterPlan(plan, ExprBinder(ctx).bind(sel.where))
        return plan, ctx

    def _bind_lateral_flatten(self, j: A.Join, ctes, state: ScanState):
        """t, [LATERAL] FLATTEN(input => t.col, ...) f — explode a
        variant/array expression per left row (reference: lateral flatten
        srf join)."""
        from ..types import ArrayType, String, UInt64, VariantType
        from .plans import LateralFlattenPlan
        left, lctx = self._bind_table_ref(j.left, ctes, ScanState())
        state.scan = None
        state.table_info = None
        ref = j.right
        params = {"path": "", "outer": False, "mode": "both",
                  "recursive": False}
        input_ast = None
        for i, a in enumerate(ref.args):
            if isinstance(a, A.NamedArg):
                if a.name == "input":
                    input_ast = a.expr
                elif a.name in params:
                    if not isinstance(a.expr, A.Literal):
                        raise SemanticError(
                            f"flatten {a.name} must be a constant")
                    params[a.name] = a.expr.value
                else:
                    raise SemanticError(f"unknown flatten argument {a.name}")
            elif i == 0:
                input_ast = a
            else:
                raise SemanticError("flatten takes one positional argument")
        if input_ast is None:
            raise SemanticError("flatten requires input =>")
        input_e = ExprBinder(lctx).bind(input_ast)
        unnest = ref.name.lower() == "unnest"
        in_t = input_e.dtype.remove_nullable()
        elem_t = (in_t.inner.wrap_nullable() if isinstance(in_t, ArrayType)
                  else VariantType().wrap_nullable())
        variant_n = VariantType().wrap_nullable()
        flat = [DataField("seq", UInt64),
                DataField("key", String.wrap_nullable()),
                DataField("path", String.wrap_nullable()),
                DataField("index", Int64.wrap_nullable()),
                DataField("value", elem_t if unnest else variant_n),
                DataField("this", variant_n)]
        alias = ref.alias or ref.name.lower()
        ctx = BindContext()
        out_fields: List[DataField] = []
        lnames = set()
        for (n, t, tb, on) in lctx.columns:
            ctx.add(n, t, tb, on)
            out_fields.append(DataField(on, t))
            lnames.add(n.lower())
        for f in flat:
            uniq = f"{alias}.{f.name}" if f.name in lnames else f.name
            ctx.add(f.name, f.dtype, alias, uniq)
            out_fields.append(DataField(uniq, f.dtype))
        plan = LateralFlattenPlan(left, input_e, params, out_fields, unnest)
        return plan, ctx

    def _bind_pivot(self, ref: A.PivotRef, ctes):
        """PIVOT(agg(v) FOR c IN (x, y)) -> GROUP BY the remaining columns
        with one conditional aggregate per IN value (reference: pivot
        rewritten to aggregation in the binder)."""
        state = ScanState()
        inner, ictx = self._bind_table_ref(ref.inner, ctes, state)
        cols = [(n, t) for (n, t, _tb, _on) in ictx.columns]
        drop = {ref.value_col.lower(), ref.for_col.lower()}
        keys = [(n, BoundColumn(n, t)) for n, t in cols
                if n.lower() not in drop]
        val = next((BoundColumn(n, t) for n, t in cols
                    if n.lower() == ref.value_col.lower()), None)
        fcol = next((BoundColumn(n, t) for n, t in cols
                     if n.lower() == ref.for_col.lower()), None)
        if val is None or fcol is None:
            raise SemanticError("PIVOT value/for column not found")
        agg_name = ref.agg.lower() + "_if"
        in_values = ref.in_values
        sub = getattr(ref, "in_subquery", None)
        if sub is not None:
            # dynamic pivot: run the IN subquery at bind time; sorted
            # distinct values become the pivot columns
            from ..pipeline.executor import execute_plan
            block = execute_plan(self.bind_query(sub, ctes))
            if block.num_columns() != 1:
                raise SemanticError("PIVOT IN subquery must return one"
                                    " column")
            in_values = sorted({v for v in block.column_at(0).to_pylist()
                                if v is not None})
        aggs = []
        for v in in_values:
            cond = Func("eq", [fcol, Constant(v, infer_literal_type(v))],
                        Boolean)
            fn = create_aggregate(agg_name, [val.dtype, Boolean], False)
            aggs.append((str(v), fn, [val, cond]))
        plan = AggregatePlan(inner, keys, aggs)
        ctx = BindContext()
        alias = ref.alias
        for f in plan.output_fields():
            ctx.add(f.name, f.dtype, alias)
        return plan, ctx

    def _bind_unpivot(self, ref: A.UnpivotRef, ctes):
        """UNPIVOT(v FOR n IN (c1, c2)) -> UNION ALL of one projection per
        column, carrying the column's name as the n output."""
        state = ScanState()
        inner, ictx = self._bind_table_ref(ref.inner, ctes, state)
        cols = [(n, t) for (n, t, _tb, _on) in ictx.columns]
        unpiv = {c.lower() for c in ref.columns}
        keys = [(n, t) for n, t in cols if n.lower() not in unpiv]
        from ..types import String as _Str
        branches = []
        for c in ref.columns:
            src = next(((n, t) for n, t in cols if n.lower() == c.lower()),
                       None)
            if src is None:
                raise SemanticError(f"UNPIVOT column {c!r} not found")
            items = [(n, BoundColumn(n, t)) for n, t in keys]
            items.append((ref.name_name, Constant(src[0], _Str)))
            items.append((ref.value_name, BoundColumn(src[0], src[1])))
            branches.append(ProjectPlan(inner, items))
        plan = UnionAllPlan(branches)
        ctx = BindContext()
        for f in plan.output_fields():
            ctx.add(f.name, f.dtype, ref.alias)
        return plan, ctx

    def _apply_policies(self, info, scan, ctx):
        """Row access policy filter + masking-policy projections wrapped
        around the scan at bind time (reference: EE data_mask /
        row_access_policy applied in the binder so masked values never
        reach later operators). Returns None when the table has none."""
        mask_cols = {k[5:]: v for k, v in info.options.items()
                     if k.startswith("mask:")}
        row_access = info.options.get("row_access")
        virtual_cols = {}
        for k, v in info.options.items():
            if k.startswith("computed:"):
                kind, _, expr = v.partition(":")
                if kind == "VIRTUAL":
                    virtual_cols[k[len("computed:"):]] = expr
        if not mask_cols and not row_access and not virtual_cols:
            return None
        pm = self.session.policies
        plan = scan
        if row_access:
            from ..license import check_feature
            check_feature(self.session, "row_access_policy")
            from ..service.policies import parse_policy_expr
            pname, _, cols_s = row_access.partition(":")
            policy = pm.get_row_access(pname)
            cols = cols_s.split(",") if cols_s else []
            if len(cols) != len(policy.args):
                raise SemanticError(
                    f"row access policy {pname!r} arity mismatch")
            pctx = BindContext()
            for (arg_name, _t), col in zip(policy.args, cols):
                f = info.schema.field(col)
                pctx.add(arg_name, f.dtype, None, f.name)
            cond = ExprBinder(pctx).bind(parse_policy_expr(policy.body))
            plan = FilterPlan(plan, cond)
        if mask_cols or virtual_cols:
            from ..service.policies import parse_policy_expr
            if mask_cols:
                from ..license import check_feature
                check_feature(self.session, "data_mask")
            base_ctx = BindContext()
            for f in info.schema.fields:
                base_ctx.add(f.name, f.dtype, None, f.name)
            items = []
            for f in info.schema.fields:
                vexpr = (virtual_cols.get(f.name.lower())
                         or virtual_cols.get(f.name))
                if vexpr is not None:
                    # VIRTUAL computed column: evaluated at scan time over
                    # the stored columns (reference computed_column EE)
                    e = ExprBinder(base_ctx).bind(parse_policy_expr(vexpr))
                    if e.dtype.remove_nullable() != f.dtype.remove_nullable():
                        e = CastExpr(e, f.dtype, False)
                    items.append((f.name, e))
                    continue
                pname = mask_cols.get(f.name.lower()) or mask_cols.get(f.name)
                if pname is None:
                    items.append((f.name, BoundColumn(f.name, f.dtype)))
                    continue
                policy = pm.get_masking(pname)
                pctx = BindContext()
                pctx.add(policy.arg_name, f.dtype, None, f.name)
                e = ExprBinder(pctx).bind(parse_policy_expr(policy.body))
                if e.dtype.remove_nullable() != f.dtype.remove_nullable():
                    e = CastExpr(e, f.dtype, False)
                items.append((f.name, e))
            plan = ProjectPlan(plan, items)
        return plan

    def _bind_table_function(self, ref: A.TableFunctionRef, state: ScanState):
        from ..service.table_functions import bind_table_function
        plan = bind_table_function(self.session, ref)
        ctx = BindContext()
        for f in plan.output_fields():
            ctx.add(f.name, f.dtype, ref.alias or ref.name)
        state.scan = None
        state.table_info = None
        return plan, ctx

    @staticmethod
    def _args_reference_columns(args) -> bool:
        from .decorrelate import _refs_outside
        for a in args:
            e = a.expr if isinstance(a, A.NamedArg) else a
            if e is not None and _refs_outside(e, set()) \
                    or isinstance(e, A.ColumnRef):
                return True
        return False

    def _bind_join(self, j: A.Join, ctes, state: ScanState):
        if isinstance(j.right, A.TableFunctionRef) \
                and j.right.name.lower() in ("flatten", "unnest") \
                and (j.right.lateral
                     or self._args_reference_columns(j.right.args)):
            return self._bind_lateral_flatten(j, ctes, state)
        if isinstance(j.right, A.SubqueryRef) and j.right.lateral \
                and isinstance(j.right.query.body, A.SelectStmt) \
                and j.right.query.body.from_ is None:
            return self._bind_lateral_project(j, ctes, state)
        if j.kind in ("RSEMI", "RANTI"):
            # RIGHT SEMI/ANTI keep the RIGHT side's rows: bind as the
            # mirrored left-side semi/anti join (reference join types)
            j = A.Join("SEMI" if j.kind == "RSEMI" else "ANTI",
                       j.right, j.left, j.condition, j.using,
                       natural=j.natural)
        lstate, rstate = ScanState(), ScanState()
        left, lctx = self._bind_table_ref(j.left, ctes, lstate)
        right, rctx = self._bind_table_ref(j.right, ctes, rstate)
        if getattr(j, "natural", False):
            ln = [n.lower() for (n, _, _, _) in lctx.columns]
            shared = [n for n in ln
                      if any(rn.lower() == n
                             for (rn, _, _, _) in rctx.columns)]
            if not shared:
                # no common columns: NATURAL degenerates to the cross
                # product (condition TRUE for outer kinds)
                j = A.Join("CROSS" if j.kind == "INNER" else j.kind,
                           j.left, j.right,
                           None if j.kind == "INNER" else A.Literal(True))
            else:
                j = A.Join(j.kind, j.left, j.right, None, shared)
        state.scan = None
        state.table_info = None
        # disambiguate duplicate output names across the two sides
        lnames = {n.lower() for (n, _, _, _) in lctx.columns}
        rnames = {n.lower() for (n, _, _, _) in rctx.columns}
        dup = lnames & rnames
        ctx = BindContext()
        ctx.db_quals = lctx.db_quals | rctx.db_quals
        out_fields: List[DataField] = []
        for (n, t, tb, on) in lctx.columns:
            uniq = f"{tb or 'l'}.{on}" if n.lower() in dup else on
            ctx.add(n, t, tb, uniq)
            out_fields.append(DataField(uniq, t))
        for (n, t, tb, on) in rctx.columns:
            uniq = f"{tb or 'r'}.{on}" if n.lower() in dup else on
            ctx.add(n, t, tb, uniq)
            out_fields.append(DataField(uniq, t))
        if j.kind in ("LEFT", "FULL"):
            out_fields = [DataField(f.name, f.dtype if i < len(lctx.columns)
                                    else f.dtype.wrap_nullable())
                          for i, f in enumerate(out_fields)]
        if j.kind in ("RIGHT", "FULL"):
            out_fields = [DataField(f.name, f.dtype.wrap_nullable()
                                    if i < len(lctx.columns) else f.dtype)
                          for i, f in enumerate(out_fields)]

        left_keys: List[ScalarExpr] = []
        right_keys: List[ScalarExpr] = []
        residual: Optional[ScalarExpr] = None
        if j.using:
            nl = len(lctx.columns)
            for u in j.using:
                left_keys.append(ExprBinder(lctx).bind(A.ColumnRef(u)))
                right_keys.append(ExprBinder(rctx).bind(A.ColumnRef(u)))
                # the using column appears ONCE in SELECT * and resolves
                # unqualified to the preserved side (left except RIGHT
                # joins); qualified refs still reach both originals
                lpos = [i for i, (n, _, _, _) in enumerate(ctx.columns[:nl])
                        if n.lower() == u.lower()]
                rpos = [nl + i for i, (n, _, _, _)
                        in enumerate(ctx.columns[nl:])
                        if n.lower() == u.lower()]
                if lpos and rpos:
                    keep, hide = (rpos[0], lpos[0]) if j.kind == "RIGHT" \
                        else (lpos[0], rpos[0])
                    ctx.star_hidden.add(ctx.columns[hide][3])
                    ctx.using_pref[u.lower()] = ctx.columns[keep][3]
        elif j.condition is not None:
            residual = self._split_join_condition(
                j.condition, lctx, rctx, ctx, left_keys, right_keys)
        elif j.kind != "CROSS":
            raise SemanticError("JOIN requires ON or USING")

        all_fields = None
        if j.kind in ("SEMI", "ANTI"):
            # semi/anti joins expose only the probe side's columns
            all_fields = out_fields
            out_fields = all_fields[:len(lctx.columns)]
            ctx = BindContext()
            for (n, t, tb, on), f in zip(lctx.columns, out_fields):
                ctx.add(n, t, tb, f.name)
        plan = JoinPlan(j.kind, left, right, left_keys, right_keys, residual,
                        out_fields, distributed=self._distributed_on(),
                        spill_threshold_rows=self._spill_rows(
                            "join_spill_row_threshold"),
                        runtime_filter=self._setting_bool(
                            "enable_join_runtime_filter", True),
                        all_fields=all_fields)
        return plan, ctx

    def _distributed_on(self) -> bool:
        try:
            return bool(self.session.settings.get(
                "enable_distributed_execution"))
        except Exception:
            return False

    def _spill_rows(self, setting: str) -> Optional[int]:
        try:
            return int(self.session.settings.get(setting)) or None
        except Exception:
            return None

    def _setting_bool(self, setting: str, default: bool) -> bool:
        try:
            return bool(self.session.settings.get(setting))
        except Exception:
            return default

    def _split_join_condition(self, cond: A.Expr, lctx, rctx, joined_ctx,
                              left_keys, right_keys) -> Optional[ScalarExpr]:
        """Pull equi-conjuncts into hash keys; the rest becomes residual."""
        residual_parts: List[A.Expr] = []

        def visit(e: A.Expr):
            if isinstance(e, A.BinaryOp) and e.op == "AND":
                visit(e.left)
                visit(e.right)
                return
            if isinstance(e, A.BinaryOp) and e.op == "=":
                for a, b in ((e.left, e.right), (e.right, e.left)):
                    try:
                        le = ExprBinder(lctx).bind(a)
                        re_ = ExprBinder(rctx).bind(b)
                        left_keys.append(le)
                        right_keys.append(re_)
                        return
                    except Exception:
                        continue
            residual_parts.append(e)

        visit(cond)
        if not residual_parts:
            return None
        acc = None
        binder = ExprBinder(joined_ctx)
        for p in residual_parts:
            e = binder.bind(p)
            acc = e if acc is None else Func("and", [acc, e], Boolean)
        return acc

    # --------------------------------------------------------------- helpers
    def _substitute_where_aliases(self, where: A.Expr,
                                  items: List[A.SelectItem],
                                  ctx: BindContext) -> A.Expr:
        """Replace unqualified ColumnRefs in WHERE that name a select-item
        alias (and are not real columns) with the aliased expression."""
        aliases = {}
        for it in items:
            if it.alias:
                aliases[it.alias.lower()] = it.expr

        depth = [0]

        def subst(e):
            if isinstance(e, A.ColumnRef) and e.table is None \
                    and e.name.lower() in aliases:
                try:
                    ctx.resolve(e.name, None)
                    return e  # a real column shadows the alias
                except Exception:
                    import copy as _copy
                    if depth[0] > 8:  # mutual alias recursion guard
                        return e
                    depth[0] += 1
                    try:
                        # chained aliases: d = rank() OVER (ORDER BY s)
                        # where s is itself an alias — substitute inside
                        # the replacement too
                        return subst(_copy.deepcopy(
                            aliases[e.name.lower()]))
                    finally:
                        depth[0] -= 1
            if hasattr(e, "__dataclass_fields__"):
                for fn in e.__dataclass_fields__:
                    v = getattr(e, fn)
                    if isinstance(v, A.Expr):
                        setattr(e, fn, subst(v))
                    elif hasattr(v, "__dataclass_fields__"):
                        subst(v)  # WindowSpec / OrderByExpr and the like
                    elif isinstance(v, list):
                        for i, x in enumerate(v):
                            if isinstance(x, A.Expr):
                                v[i] = subst(x)
                            elif hasattr(x, "__dataclass_fields__"):
                                subst(x)
            return e

        if not aliases:
            return where
        import copy as _copy
        return subst(_copy.deepcopy(where))

    def _expand_stars(self, items: List[A.SelectItem], ctx: BindContext):
        out = []
        for item in items:
            if isinstance(item.expr, A.Star):
                excluded = {c.lower() for c in item.expr.exclude}
                repl = {c.lower(): e for c, e in
                        getattr(item.expr, "replace", [])}
                for (n, t, tb, on) in ctx.columns:
                    if n.lower() in excluded:
                        continue
                    if on in ctx.star_hidden:
                        continue  # JOIN USING: the column appears once
                    if item.expr.table is None or \
                            (tb or "").lower() == item.expr.table.lower():
                        if n.lower() in repl:
                            out.append(A.SelectItem(repl[n.lower()], n))
                        else:
                            out.append(A.SelectItem(A.ColumnRef(n, tb),
                                                    None))
                if not ctx.columns:
                    raise SemanticError("SELECT * with no FROM")
            else:
                out.append(item)
        return out

    def _bind_with_group_rewrite(self, e: A.Expr, binder: SelectExprBinder,
                                 group_key_asts: List[str],
                                 group_keys) -> ScalarExpr:
        key = _ast_repr(e)
        for i, ga in enumerate(group_key_asts):
            if key == ga:
                name, ge = group_keys[i]
                return BoundColumn(name, ge.dtype)
        if not _contains_group_subtree(e, group_key_asts):
            return binder.bind(e)
        if isinstance(e, A.BinaryOp):
            l = self._bind_with_group_rewrite(e.left, binder, group_key_asts, group_keys)
            r = self._bind_with_group_rewrite(e.right, binder, group_key_asts, group_keys)
            from .expr_binder import _BINOP_FN
            name = _BINOP_FN.get(e.op)
            if name in ("eq", "noteq", "lt", "lte", "gt", "gte"):
                l, r = binder._coerce_comparison(l, r)
            return binder._func(name, [l, r])
        if isinstance(e, A.FunctionCall) and not is_aggregate_function(e.name):
            # non-aggregate call over grouped subtrees: rebind args recursively
            args = [self._bind_with_group_rewrite(a, binder, group_key_asts, group_keys)
                    for a in e.args]
            if registry.contains(e.name):
                return binder._func(e.name.lower(), args)
        return binder.bind(e)

    def _finalize_scan(self, state: ScanState, where_expr, sort_items,
                       limit, bound_items):
        scan = state.scan
        if scan is None:
            return
        pd = scan.pushdown
        if self.session.settings.get("enable_distributed_pruning"):
            # the reference's jax.device_count() > 1: a mesh over two or
            # more cards, or an installed one
            from ..parallel.mesh import get_default_mesh
            pd.enable_distributed = get_default_mesh() is not None
        pd.vector_search_mode = str(
            self.session.settings.get("vector_search_mode"))
        pd.vector_exact_scan_max_rows = int(
            self.session.settings.get("vector_exact_scan_max_rows"))
        pd.vector_host_scan_max_rows = int(
            self.session.settings.get("vector_host_scan_max_rows"))
        pd.enable_topn = bool(self.session.settings.get("enable_top_n"))
        if state.vector_rewrite is not None:
            pd.vector_index = state.vector_rewrite
            scan.internal_columns.append(VECTOR_SCORE_COL_NAME)

            def _is_score_col(name: str) -> bool:
                if name == VECTOR_SCORE_COL_NAME:
                    return True
                e = next((e for n, e in bound_items if n == name), None)
                return isinstance(e, BoundColumn) and e.name == VECTOR_SCORE_COL_NAME

            first_sort_is_score = bool(sort_items) and \
                _is_score_col(sort_items[0].name) and sort_items[0].asc
            # mirror reference gating: HNSW prune only for
            # (no filter, ASC score order, limit)
            pd.vector_index.topk_asc = (
                where_expr is None and first_sort_is_score and limit is not None)
        if state.inverted_rewrite is not None:
            pd.inverted_index = state.inverted_rewrite
            scan.internal_columns.append(SEARCH_MATCHED_COL_NAME)
            if state.used_score_fn:
                pd.inverted_index.has_score = True
                scan.internal_columns.append(SEARCH_SCORE_COL_NAME)
        if limit is not None and isinstance(limit, A.Literal):
            lim = int(limit.value)
            if not sort_items and where_expr is None:
                pd.limit = lim
            elif sort_items:
                # topn pushdown: sort on plain columns or _vector_score
                first = sort_items[0]
                pd.order_by = [Range(first.name, first.asc)]
                pd.limit = lim

    def _bind_subquery_expr(self, e, binder: SelectExprBinder, ctes):
        from .subquery import bind_subquery_expr
        return bind_subquery_expr(self.session, e, binder, ctes)


def _clone_plan(plan):
    """Per-consumer copy of a plan tree: plan nodes and pushdowns are
    copied (the optimizer mutates them in place), data payloads
    (blocks, table handles) are shared."""
    import copy as _copy
    import dataclasses as _dc
    if not isinstance(plan, Plan):
        return plan
    node = _copy.copy(plan)
    if isinstance(node, Scan):
        node.pushdown = _copy.deepcopy(node.pushdown)
        return node
    for f in _dc.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Plan):
            setattr(node, f.name, _clone_plan(v))
        elif isinstance(v, list) and v and isinstance(v[0], Plan):
            setattr(node, f.name, [_clone_plan(x) for x in v])
    return node


def _contains_window(e) -> bool:
    if isinstance(e, A.FunctionCall) and e.window is not None:
        return True
    return any(_contains_window(c) for c in _ast_children(e))


def _contains_aggregate(e) -> bool:
    if isinstance(e, A.FunctionCall) and e.window is None \
            and is_aggregate_function(e.name.lower()):
        return True
    return any(_contains_aggregate(c) for c in _ast_children(e))


def _ast_children(e):
    """Child Expr nodes of an AST expression (generic dataclass walk)."""
    import dataclasses
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, A.Expr):
                    yield x


def _ast_repr(e) -> str:
    return repr(e)


def _contains_group_subtree(e, group_key_asts: List[str]) -> bool:
    if not group_key_asts:
        return False
    if _ast_repr(e) in group_key_asts:
        return True
    kids = []
    if isinstance(e, A.BinaryOp):
        kids = [e.left, e.right]
    elif isinstance(e, A.UnaryOp):
        kids = [e.operand]
    elif isinstance(e, A.FunctionCall):
        kids = e.args
    elif isinstance(e, A.Cast):
        kids = [e.expr]
    elif isinstance(e, A.Case):
        kids = ([e.operand] if e.operand else []) + e.conditions + e.results + \
            ([e.else_result] if e.else_result else [])
    return any(_contains_group_subtree(k, group_key_asts) for k in kids)


def _suggest_name(e: A.Expr) -> Optional[str]:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.FunctionCall):
        return _ast_display(e)
    if isinstance(e, A.Literal):
        return str(e.value)
    return _ast_display(e)


def _ast_display(e: A.Expr) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.Literal):
        return repr(e.value) if not isinstance(e.value, str) else f"'{e.value}'"
    if isinstance(e, A.FunctionCall):
        inner = ", ".join(_ast_display(a) for a in e.args)
        if not e.args:
            inner = "*" if e.name.lower() == "count" else ""
        return f"{e.name.lower()}({inner})"
    if isinstance(e, A.BinaryOp):
        return f"{_ast_display(e.left)} {e.op} {_ast_display(e.right)}"
    if isinstance(e, A.Star):
        return "*"
    return type(e).__name__.lower()


def _expr_eq(a: ScalarExpr, b: ScalarExpr) -> bool:
    try:
        return a.display() == b.display()
    except Exception:
        return False


def _const_int(e) -> Optional[int]:
    if e is None:
        return None
    if isinstance(e, A.Literal) and isinstance(e.value, int):
        return int(e.value)
    # constant expressions ($var, getvariable(), 2+3) fold at bind time
    try:
        bound = ExprBinder(BindContext()).bind(e)
        from ..expression.evaluator import Evaluator
        v = Evaluator(DataBlock([], [], 1)).run(bound).get(0)
        if v is not None and float(v) == int(v):
            return int(v)
    except Exception:
        pass
    raise SemanticError("LIMIT/OFFSET must be integer literals")


def _limit_value(q: A.Query) -> Optional[int]:
    lim = _const_int(q.limit)
    off = _const_int(q.offset) or 0
    return (lim + off) if lim is not None else None


def _limit_sum(limit, offset) -> Optional[int]:
    lim = _const_int(limit)
    off = _const_int(offset) or 0
    return (lim + off) if lim is not None else None


def _cte_self_references(cq: A.Query, name: str) -> bool:
    """Does the CTE's own body reference its name as a table?"""
    import dataclasses

    def walk(o):
        if isinstance(o, A.TableName) and o.name.lower() == name.lower():
            return True
        if not dataclasses.is_dataclass(o) or isinstance(o, type):
            return False
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            vals = v if isinstance(v, (list, tuple)) else [v]
            for x in vals:
                if dataclasses.is_dataclass(x) and not isinstance(x, type) \
                        and walk(x):
                    return True
        return False

    return walk(cq)
