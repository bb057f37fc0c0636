"""Correlated subquery decorrelation: EXISTS / IN -> SEMI / ANTI joins.

Reference: subquery decorrelation in the optimizer
(src/query/sql/src/planner/optimizer/optimizers/rule/ — subquery rewrite
rules lowering correlated EXISTS/IN/ANY into (anti) semi joins).

Here the rewrite runs on the AST before binding: a top-level [NOT]
EXISTS/IN conjunct in WHERE whose inner query references OUTER tables
through qualified columns becomes a LEFT SEMI/ANTI JOIN against the inner
query, with the correlated equality conjuncts hoisted into the join
condition. Unqualified inner columns resolve inside the subquery (standard
SQL scoping), so correlation is detected through qualifiers that don't
match any inner FROM alias — the form every standard correlated query
(TPC-H q4/q21/q22 class) uses.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from . import ast as A


def split_conjuncts(e: Optional[A.Expr]) -> List[A.Expr]:
    if e is None:
        return []
    if isinstance(e, A.BinaryOp) and e.op.upper() == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def and_join(conjs: List[A.Expr]) -> Optional[A.Expr]:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = A.BinaryOp("AND", out, c)
    return out


def _from_names(ref: Optional[A.TableRef]) -> Set[str]:
    """Alias/table names a FROM clause exposes."""
    out: Set[str] = set()
    if ref is None:
        return out
    if isinstance(ref, A.TableName):
        out.add((ref.alias or ref.name).lower())
    elif isinstance(ref, (A.SubqueryRef, A.TableFunctionRef, A.StageRef,
                          A.ValuesRef)):
        alias = getattr(ref, "alias", None) or getattr(ref, "name", None)
        if alias:
            out.add(str(alias).lower())
    elif isinstance(ref, A.Join):
        out |= _from_names(ref.left)
        out |= _from_names(ref.right)
    elif isinstance(ref, (A.PivotRef, A.UnpivotRef)):
        out |= _from_names(ref.inner)
    return out


def _inner_col_set(ref: Optional[A.TableRef], resolver) -> Optional[Set[str]]:
    """Columns the inner FROM exposes (lowercase), or None if unknown.
    With a catalog resolver this lets UNQUALIFIED outer references be
    recognized (TPC-H writes `l_orderkey = o_orderkey`, no qualifiers)."""
    if ref is None:
        return set()
    if resolver is None:
        return None
    if isinstance(ref, A.TableName):
        return resolver(ref)
    if isinstance(ref, A.Join):
        a = _inner_col_set(ref.left, resolver)
        b = _inner_col_set(ref.right, resolver)
        return None if a is None or b is None else a | b
    return None  # subquery / table function / values: unknown


def _refs_outside(e: A.Expr, inner_names: Set[str],
                  inner_cols: Optional[Set[str]] = None) -> bool:
    """Any ColumnRef resolving OUTSIDE the subquery: qualified with a
    non-inner name, or (when the inner column set is known) unqualified
    and not an inner column."""
    import dataclasses
    if isinstance(e, A.ColumnRef):
        if e.table is not None:
            return e.table.lower() not in inner_names
        return inner_cols is not None and e.name.lower() not in inner_cols
    if not dataclasses.is_dataclass(e):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        vals = v if isinstance(v, (list, tuple)) else [v]
        for x in vals:
            if isinstance(x, A.Expr) and _refs_outside(x, inner_names,
                                                       inner_cols):
                return True
    return False


_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}


def _classify(conj: A.Expr, inner_names: Set[str],
              inner_cols: Optional[Set[str]] = None):
    """'inner' | ('corr', inner, outer) | ('residual', op, inner, outer,
    inner_is_left) | None (unsupported)."""
    if not _refs_outside(conj, inner_names, inner_cols):
        return "inner"
    if isinstance(conj, A.BinaryOp) and conj.op in _CMP_OPS:
        l_out = _refs_outside(conj.left, inner_names, inner_cols)
        r_out = _refs_outside(conj.right, inner_names, inner_cols)
        if l_out != r_out:
            inner_side = conj.right if l_out else conj.left
            outer_side = conj.left if l_out else conj.right
            if not _refs_outside(inner_side, inner_names, inner_cols):
                if conj.op == "=":
                    return ("corr", inner_side, outer_side)
                # non-equi correlation: hoistable into the join residual
                return ("residual", conj.op, inner_side, outer_side,
                        not l_out)
    return None


def decorrelate_where(sel: A.SelectStmt, counter: List[int],
                      resolver=None) -> None:
    """Rewrite sel.from_/sel.where in place; leaves unsupported shapes
    untouched (they follow the uncorrelated path or raise as before).
    ``resolver(A.TableName) -> set[str] | None`` supplies table columns
    so unqualified correlated references classify correctly."""
    if sel.where is None or sel.from_ is None:
        return
    keep: List[A.Expr] = []
    for conj in split_conjuncts(sel.where):
        target, negate = conj, False
        if isinstance(conj, A.UnaryOp) and conj.op == "NOT" \
                and isinstance(conj.operand, (A.Exists, A.InSubquery)):
            target, negate = conj.operand, True
        handled = False
        if isinstance(target, (A.Exists, A.InSubquery)):
            neg = negate != target.negated
            handled = _try_rewrite(sel, target, neg, counter, resolver)
        elif isinstance(conj, A.BinaryOp) and conj.op in _CMP_OPS:
            new_conj = _try_scalar_agg(sel, conj, counter, resolver)
            if new_conj is not None:
                keep.append(new_conj)
                handled = True
        if not handled:
            keep.append(conj)
    sel.where = and_join(keep)
    if sel.where is not None:
        sel.where = _rewrite_nested_exists(sel.where, resolver)


def _rewrite_nested_exists(e: A.Expr, resolver) -> A.Expr:
    """EXISTS under OR (or any boolean context the conjunct pass cannot
    reach, TPC-DS q10/q35 shape): a correlated EXISTS whose only outer
    references are equality correlations on ONE outer expression becomes
    the uncorrelated membership test
    `outer IN (SELECT inner FROM ... WHERE inner-conjs)` — exact for a
    positive EXISTS (NULL inner keys never satisfy the equality either
    way). Negated EXISTS is left alone (three-valued NOT IN differs)."""
    if isinstance(e, A.BinaryOp) and e.op in ("AND", "OR"):
        e.left = _rewrite_nested_exists(e.left, resolver)
        e.right = _rewrite_nested_exists(e.right, resolver)
        return e
    if isinstance(e, A.UnaryOp) and e.op == "NOT":
        e.operand = _rewrite_nested_exists(e.operand, resolver)
        return e
    if not isinstance(e, A.Exists) or e.negated:
        return e
    q = e.query
    body = q.body
    if not isinstance(body, A.SelectStmt) or body.from_ is None:
        return e
    if q.limit is not None or body.group_by or body.group_sets \
            or body.having is not None:
        return e
    inner_names = _from_names(body.from_)
    inner_cols = _inner_col_set(body.from_, resolver)
    inner_conjs: List[A.Expr] = []
    corr: List[Tuple[A.Expr, A.Expr]] = []
    for c in split_conjuncts(_factor_common_or(body.where)):
        kind = _classify(c, inner_names, inner_cols)
        if kind == "inner":
            inner_conjs.append(c)
        elif isinstance(kind, tuple) and kind[0] == "corr":
            corr.append((kind[1], kind[2]))
        else:
            return e
    if len(corr) != 1:
        return e   # multi-key membership needs tuple IN; keep as-is
    inner_expr, outer_expr = corr[0]
    inner_sel = A.SelectStmt([A.SelectItem(inner_expr, "__ek")],
                             body.from_, and_join(inner_conjs))
    return A.InSubquery(outer_expr, A.Query(inner_sel), False)


def _factor_common_or(e: Optional[A.Expr]) -> Optional[A.Expr]:
    """(A AND x) OR (A AND y) -> A AND (x OR y): hoist conjuncts present
    in every OR disjunct (matched by repr), recursively. Makes the
    correlation equality in TPC-DS q41's `(corr AND ...) OR (corr AND
    ...)` classifiable."""
    if e is None or not isinstance(e, A.BinaryOp):
        return e
    if e.op == "AND":
        e.left = _factor_common_or(e.left)
        e.right = _factor_common_or(e.right)
        return e
    if e.op != "OR":
        return e
    disj: List[A.Expr] = []

    def flat(x):
        if isinstance(x, A.BinaryOp) and x.op == "OR":
            flat(x.left)
            flat(x.right)
        else:
            disj.append(_factor_common_or(x))

    flat(e.left)
    flat(e.right)
    sets = [{repr(c): c for c in split_conjuncts(d)} for d in disj]
    common_keys = set(sets[0])
    for s in sets[1:]:
        common_keys &= set(s)
    if not common_keys:
        out = disj[0]
        for d in disj[1:]:
            out = A.BinaryOp("OR", out, d)
        return out
    common = [sets[0][k] for k in sorted(common_keys)]
    rests = []
    for d in disj:
        rest = [c for c in split_conjuncts(d) if repr(c) not in common_keys]
        rests.append(and_join(rest) or A.Literal(True))
    or_expr = rests[0]
    for r in rests[1:]:
        or_expr = A.BinaryOp("OR", or_expr, r)
    return and_join(common + [or_expr])


def _find_scalar_subs(e: A.Expr) -> List[A.ScalarSubquery]:
    """All ScalarSubquery nodes in an expression (not descending into
    them)."""
    import dataclasses
    out: List[A.ScalarSubquery] = []

    def walk(x):
        if isinstance(x, A.ScalarSubquery):
            out.append(x)
            return
        if not dataclasses.is_dataclass(x) or isinstance(x, A.Query):
            return
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            for y in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(y, A.Expr):
                    walk(y)

    walk(e)
    return out


def _replace_node(e: A.Expr, old: A.Expr, new: A.Expr) -> A.Expr:
    """Copy `e` with the (identity-matched) node `old` replaced by
    `new`."""
    import copy as _copy
    import dataclasses
    if e is old:
        return new
    if not dataclasses.is_dataclass(e) or isinstance(e, A.Query):
        return e
    e2 = _copy.copy(e)
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            setattr(e2, f.name, _replace_node(v, old, new))
        elif isinstance(v, list):
            setattr(e2, f.name,
                    [_replace_node(y, old, new) if isinstance(y, A.Expr)
                     else y for y in v])
    return e2


def _try_scalar_agg(sel: A.SelectStmt, conj: A.BinaryOp,
                    counter: List[int], resolver) -> Optional[A.Expr]:
    """Correlated scalar aggregate subquery in a comparison:
    `x CMP (SELECT agg(...) FROM inner WHERE corr-eqs AND ...)` becomes
    an INNER join against the GROUP BY corr-keys aggregate (TPC-H q2/
    q17/q20 shape; reference: scalar-subquery-to-join rule). A missing
    group yields scalar NULL -> comparison UNKNOWN -> row filtered, which
    the inner join reproduces exactly for a positive WHERE conjunct.

    The subquery may sit under arithmetic (`price > 1.2 * (SELECT avg..)`,
    TPC-DS q1/q6/q30 shape) — NULL propagates through the arithmetic, so
    the missing-group semantics are unchanged."""
    subs = _find_scalar_subs(conj)
    if len(subs) != 1:
        return None
    sub = subs[0]
    q = sub.query
    body = q.body
    if not isinstance(body, A.SelectStmt) or body.from_ is None:
        return None
    if q.limit is not None or body.group_by or body.group_sets \
            or body.having is not None or len(body.items) != 1:
        return None
    if not _has_agg(body.items[0].expr):
        return None
    inner_names = _from_names(body.from_)
    inner_cols = _inner_col_set(body.from_, resolver)
    inner_conjs: List[A.Expr] = []
    corr: List[Tuple[A.Expr, A.Expr]] = []
    for c in split_conjuncts(_factor_common_or(body.where)):
        kind = _classify(c, inner_names, inner_cols)
        if kind == "inner":
            inner_conjs.append(c)
        elif isinstance(kind, tuple) and kind[0] == "corr":
            corr.append((kind[1], kind[2]))
        else:
            return None
    if not corr:
        return None  # uncorrelated: the eager constant fold handles it
    alias = f"__sa{counter[0]}"
    counter[0] += 1
    items = [A.SelectItem(ins, f"__ck{i}") for i, (ins, _) in enumerate(corr)]
    items.append(A.SelectItem(body.items[0].expr, "__v"))
    grouped = A.SelectStmt(items, body.from_, and_join(inner_conjs),
                           group_by=[ins for ins, _ in corr])
    on = and_join([A.BinaryOp("=", A.ColumnRef(f"__ck{i}", alias), outer)
                   for i, (_, outer) in enumerate(corr)])
    sel.from_ = A.Join("INNER", sel.from_,
                       A.SubqueryRef(A.Query(grouped), alias), on)
    return _replace_node(conj, sub, A.ColumnRef("__v", alias))


_AGG_NAMES = {"sum", "avg", "min", "max", "count", "count_distinct",
              "stddev", "stddev_pop", "stddev_samp", "variance"}


def _has_agg(e: A.Expr) -> bool:
    import dataclasses
    if isinstance(e, A.FunctionCall) and e.name.lower() in _AGG_NAMES:
        return True
    if not dataclasses.is_dataclass(e) or isinstance(e, A.Query):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        vals = v if isinstance(v, (list, tuple)) else [v]
        for x in vals:
            if isinstance(x, A.Expr) and _has_agg(x):
                return True
    return False


def _try_rewrite(sel: A.SelectStmt, target, negated: bool,
                 counter: List[int], resolver=None) -> bool:
    q = target.query
    body = q.body
    if not isinstance(body, A.SelectStmt) or body.from_ is None:
        return False
    if q.limit is not None or body.group_by or body.group_sets \
            or body.having is not None:
        return False
    inner_names = _from_names(body.from_)
    inner_cols = _inner_col_set(body.from_, resolver)
    inner_conjs: List[A.Expr] = []
    corr: List[Tuple[A.Expr, A.Expr]] = []
    resids: List[Tuple[str, A.Expr, A.Expr, bool]] = []
    for c in split_conjuncts(_factor_common_or(body.where)):
        kind = _classify(c, inner_names, inner_cols)
        if kind == "inner":
            inner_conjs.append(c)
        elif isinstance(kind, tuple) and kind[0] == "corr":
            corr.append((kind[1], kind[2]))
        elif isinstance(kind, tuple) and kind[0] == "residual":
            resids.append((kind[1], kind[2], kind[3], kind[4]))
        else:
            return False  # unsupported correlation shape: leave untouched
    if not corr:
        return False  # uncorrelated: the constant-folding path handles it
    alias = f"__sq{counter[0]}"
    counter[0] += 1
    items = [A.SelectItem(ins, f"__c{i}") for i, (ins, _) in enumerate(corr)]
    on_parts = [A.BinaryOp("=", A.ColumnRef(f"__c{i}", alias), outer)
                for i, (_, outer) in enumerate(corr)]
    # non-equi correlated conjuncts ride the join residual: hoist the
    # pure-inner side as a select item (TPC-H q21's l2.l_suppkey <>
    # l1.l_suppkey), the binder routes non-equi ON conjuncts to residual
    for i, (op, ins, outer, inner_is_left) in enumerate(resids):
        items.append(A.SelectItem(ins, f"__r{i}"))
        rcol = A.ColumnRef(f"__r{i}", alias)
        on_parts.append(A.BinaryOp(op, rcol, outer) if inner_is_left
                        else A.BinaryOp(op, outer, rcol))
    if isinstance(target, A.InSubquery):
        if len(body.items) != 1:
            return False
        items.append(A.SelectItem(body.items[0].expr, "__v"))
        v = A.ColumnRef("__v", alias)
        if negated:
            # NOT IN is three-valued: if the (correlated) subquery yields
            # any NULL, or the outer expr is NULL with a non-empty inner
            # set, the row must be filtered. A plain equality ANTI join
            # would keep it. Lower to a NULL-aware anti join instead:
            # pair on the correlation keys, and treat `v = x OR v IS NULL
            # OR x IS NULL` as the match condition (reference lowers NOT
            # IN via a null-aware mark join). The binder routes this
            # disjunction to the join residual, which the ANTI executor
            # evaluates per matched pair.
            on_parts.append(A.BinaryOp(
                "OR",
                A.BinaryOp("OR", A.BinaryOp("=", v, target.expr),
                           A.IsNull(v)),
                A.IsNull(target.expr)))
        else:
            on_parts.append(A.BinaryOp("=", v, target.expr))
    inner_sel = A.SelectStmt(items, body.from_, and_join(inner_conjs))
    sub = A.SubqueryRef(A.Query(inner_sel), alias)
    sel.from_ = A.Join("ANTI" if negated else "SEMI", sel.from_, sub,
                       and_join(on_parts))
    return True


# --------------------------------------------------------- ANY / ALL / SOME
# Reference: quantified-comparison subquery rewrite (the optimizer lowers
# `x <op> ANY/ALL (q)` into IN-subqueries or min/max scalar aggregates).

_ANYALL_UNSUPPORTED = "unsupported quantified comparison: {} {}"


def _scalar_agg(q: A.Query, agg: str) -> A.Query:
    """`(SELECT agg(__v) FROM (q renamed to __v) __aa)`."""
    import dataclasses
    body = q.body
    if not isinstance(body, A.SelectStmt) or len(body.items) != 1:
        raise ValueError("quantified subquery must select one column")
    new_body = dataclasses.replace(
        body, items=[A.SelectItem(body.items[0].expr, "__v")])
    inner = A.Query(new_body, order_by=q.order_by, limit=q.limit,
                    offset=q.offset, ctes=q.ctes)
    outer = A.SelectStmt(
        [A.SelectItem(A.FunctionCall(agg, [A.ColumnRef("__v", "__aa")]),
                      None)],
        A.SubqueryRef(inner, "__aa"))
    return A.Query(outer)


def _lower_any_all(op: str, lhs: A.Expr, rhs: "A.AnyAllSubquery") -> A.Expr:
    kind, q = rhs.kind, rhs.query
    if op == "=" and kind == "ANY":
        return A.InSubquery(lhs, q)
    if op in ("<>", "!=") and kind == "ALL":
        return A.InSubquery(lhs, q, negated=True)

    def mm(agg: str) -> A.Expr:
        return A.ScalarSubquery(_scalar_agg(q, agg))

    if op in ("<", "<="):
        return A.BinaryOp(op, lhs, mm("max" if kind == "ANY" else "min"))
    if op in (">", ">="):
        return A.BinaryOp(op, lhs, mm("min" if kind == "ANY" else "max"))
    if op == "=" and kind == "ALL":
        # every v equals x  <=>  min(v)=x AND max(v)=x (empty set caveat)
        return A.BinaryOp("AND", A.BinaryOp("=", lhs, mm("min")),
                          A.BinaryOp("=", lhs, mm("max")))
    if op in ("<>", "!=") and kind == "ANY":
        # exists v <> x  <=>  min(v)<>x OR max(v)<>x
        return A.BinaryOp("OR", A.BinaryOp("<>", lhs, mm("min")),
                          A.BinaryOp("<>", lhs, mm("max")))
    raise ValueError(_ANYALL_UNSUPPORTED.format(op, kind))


def rewrite_any_all(e: Optional[A.Expr]) -> Optional[A.Expr]:
    """Replace `x <op> ANY/ALL (subquery)` nodes; recurses through scalar
    expressions but not into subquery bodies (those rewrite when bound)."""
    import dataclasses
    if e is None or isinstance(e, A.Query) or not dataclasses.is_dataclass(e):
        return e
    if isinstance(e, A.BinaryOp):
        e.left = rewrite_any_all(e.left)
        if isinstance(e.right, A.AnyAllSubquery):
            return _lower_any_all(e.op, e.left, e.right)
        e.right = rewrite_any_all(e.right)
        return e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            setattr(e, f.name, rewrite_any_all(v))
        elif isinstance(v, list):
            setattr(e, f.name,
                    [rewrite_any_all(x) if isinstance(x, A.Expr) else x
                     for x in v])
    return e
