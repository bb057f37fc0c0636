"""MERGE INTO execution.

Reference analog: the merge-into pipeline (benchmark/merge_into/, merge
interpreters under src/query/service/src/interpreters/). Strategy for this
engine's immutable-block storage: materialize target and source, hash-join
on the equi keys of the ON condition (residual evaluated on candidate
pairs), apply WHEN [NOT] MATCHED clauses vectorized, rewrite the table in
one OCC commit. Clause order wins per row; a target row matching multiple
source rows takes the first source match (documented divergence: the
reference errors on multi-match by default).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import SemanticError
from ..expression import Column, DataBlock
from ..expression.evaluator import Evaluator, cast_column
from ..sql import ast as A
from ..sql.expr_binder import BindContext, ExprBinder


def _split_on(on: A.Expr) -> Tuple[List[Tuple[A.Expr, A.Expr]], Optional[A.Expr]]:
    """AND-ed equality conjuncts -> (pairs, residual)."""
    eqs: List[Tuple[A.Expr, A.Expr]] = []
    residual: List[A.Expr] = []

    def visit(e: A.Expr):
        if isinstance(e, A.BinaryOp) and e.op == "AND":
            visit(e.left)
            visit(e.right)
        elif isinstance(e, A.BinaryOp) and e.op in ("=", "=="):
            eqs.append((e.left, e.right))
        else:
            residual.append(e)

    visit(on)
    if not eqs:
        raise SemanticError("MERGE requires at least one equality in ON")
    out_res = None
    for r in residual:
        out_res = r if out_res is None else A.BinaryOp("AND", out_res, r)
    return eqs, out_res


def _table_side(e: A.Expr, tgt_names, tgt_alias, src_names, src_alias) -> str:
    """Which side an ON equality operand references."""
    if isinstance(e, A.ColumnRef):
        if e.table is not None:
            if tgt_alias and e.table.lower() == tgt_alias.lower():
                return "target"
            if src_alias and e.table.lower() == src_alias.lower():
                return "source"
        n = e.name.lower()
        in_t, in_s = n in tgt_names, n in src_names
        if in_t and not in_s:
            return "target"
        if in_s and not in_t:
            return "source"
    raise SemanticError(
        "MERGE ON equality operands must be unambiguous column references")


def execute_merge(session, st: A.MergeInto):
    from ..pipeline.executor import execute_plan
    from ..sql.binder import Binder, ScanState

    db = st.target_database or session.current_database
    session.check_privilege("UPDATE", db, st.target)
    table = session.table(st.target, st.target_database)
    tgt_alias = st.target_alias or st.target

    # ---- materialize both sides
    binder = Binder(session)
    from ..catalog.pushdown import PushDownInfo
    from ..sql.plans import Scan
    tgt_block = execute_plan(Scan(table, PushDownInfo()))
    src_plan, src_ctx = binder._bind_table_ref(st.source, {}, ScanState())
    src_block = execute_plan(src_plan)
    src_alias = getattr(st.source, "alias", None) or getattr(
        st.source, "name", None)

    tgt_names = {f.name.lower() for f in table.schema.fields}
    src_names = {n.lower() for n in src_block.names}

    # ---- bind contexts: per-side and combined (for conditions/updates)
    tctx = BindContext()
    for f in table.schema.fields:
        tctx.add(f.name, f.dtype, tgt_alias)
    sctx = BindContext()
    for n, c in src_block.items():
        sctx.add(n, c.dtype, src_alias)
    both = BindContext()
    for f in table.schema.fields:
        both.add(f.name, f.dtype, tgt_alias)
    for n, c in src_block.items():
        # disambiguate duplicate names with a source prefix
        out_name = n if n.lower() not in tgt_names else f"__src_{n}"
        both.columns.append((n, c.dtype.wrap_nullable()
                             if not c.dtype.is_nullable() else c.dtype,
                             src_alias, out_name))

    eqs, residual = _split_on(st.on)

    # ---- hash join on equi keys (first source match wins)
    t_ev, s_ev = Evaluator(tgt_block), Evaluator(src_block)
    t_keys, s_keys = [], []
    for a, b in eqs:
        sa = _table_side(a, tgt_names, tgt_alias, src_names, src_alias)
        te, se = (a, b) if sa == "target" else (b, a)
        t_keys.append(t_ev.run(ExprBinder(tctx).bind(te)).to_pylist())
        s_keys.append(s_ev.run(ExprBinder(sctx).bind(se)).to_pylist())
    # SQL equality never matches on NULL: rows with NULL in any equi-key
    # stay unmatched on both sides (Python tuples would treat None == None)
    smap: Dict[tuple, int] = {}
    for j in range(src_block.num_rows):
        key = tuple(k[j] for k in s_keys)
        if any(v is None for v in key):
            continue
        smap.setdefault(key, j)
    match_src = np.full(tgt_block.num_rows, -1, np.int64)
    for i in range(tgt_block.num_rows):
        key = tuple(k[i] for k in t_keys)
        if any(v is None for v in key):
            continue
        match_src[i] = smap.get(key, -1)
    matched_srcs = set(int(v) for v in match_src.tolist() if v >= 0)

    # ---- combined block of (target row, its matched source row)
    safe_src = np.maximum(match_src, 0)
    comb_names = list(tgt_block.names)
    comb_cols = list(tgt_block.columns)
    for n, c in src_block.items():
        out_name = n if n.lower() not in tgt_names else f"__src_{n}"
        comb_names.append(out_name)
        comb_cols.append(c.take(safe_src) if src_block.num_rows
                         else Column.from_pylist([None] * tgt_block.num_rows,
                                                 c.dtype.wrap_nullable()))
    comb = DataBlock(comb_names, comb_cols, tgt_block.num_rows)
    comb_ev = Evaluator(comb)
    comb_binder = ExprBinder(both)

    def comb_mask(cond) -> np.ndarray:
        if cond is None:
            return np.ones(tgt_block.num_rows, np.bool_)
        col = comb_ev.run(comb_binder.bind(cond))
        m = np.asarray(col.data, np.bool_)
        if col.validity is not None:
            m = m & col.validity
        return m

    if residual is not None:
        res_mask = comb_mask(residual)
        match_src = np.where(res_mask, match_src, -1)
        matched_srcs = set(int(v) for v in match_src.tolist() if v >= 0)
    is_matched = match_src >= 0

    # ---- apply clauses row-wise (first applicable clause wins)
    decided = np.zeros(tgt_block.num_rows, np.bool_)
    keep = np.ones(tgt_block.num_rows, np.bool_)
    out_cols = {n: c for n, c in tgt_block.items()}
    n_updated = n_deleted = 0
    for cl in st.clauses:
        if not cl.matched:
            continue
        mask = is_matched & ~decided & comb_mask(cl.condition)
        if not mask.any():
            continue
        decided |= mask
        if cl.action == "delete":
            keep &= ~mask
            n_deleted += int(mask.sum())
        elif cl.action == "update":
            for col_name, expr in cl.assignments:
                f = table.schema.field(col_name)
                new_col = comb_ev.run(comb_binder.bind(expr))
                new_col = cast_column(new_col, f.dtype, False)
                old = out_cols[f.name]
                merged_vals = [nv if m else ov for m, ov, nv in zip(
                    mask, old.to_pylist(), new_col.to_pylist())]
                out_cols[f.name] = Column.from_pylist(
                    merged_vals, f.dtype.wrap_nullable()
                    if any(v is None for v in merged_vals) else f.dtype)
            n_updated += int(mask.sum())

    # ---- WHEN NOT MATCHED inserts (over unmatched source rows)
    insert_blocks = []
    src_ev = Evaluator(src_block)
    src_binder = ExprBinder(sctx)
    unmatched = np.array([j not in matched_srcs
                          for j in range(src_block.num_rows)], np.bool_)
    src_decided = np.zeros(src_block.num_rows, np.bool_)
    for cl in st.clauses:
        if cl.matched:
            continue
        cond_mask = np.ones(src_block.num_rows, np.bool_)
        if cl.condition is not None:
            col = src_ev.run(src_binder.bind(cl.condition))
            cond_mask = np.asarray(col.data, np.bool_)
            if col.validity is not None:
                cond_mask = cond_mask & col.validity
        mask = unmatched & ~src_decided & cond_mask
        if not mask.any():
            continue
        src_decided |= mask
        cols = cl.insert_columns or table.schema.field_names()
        if len(cols) != len(cl.insert_values):
            raise SemanticError("MERGE INSERT arity mismatch")
        given = {}
        for cname, expr in zip(cols, cl.insert_values):
            f = table.schema.field(cname)
            col = src_ev.run(src_binder.bind(expr))
            col = cast_column(col, f.dtype, False)
            picked = [v for v, m in zip(col.to_pylist(), mask) if m]
            given[f.name.lower()] = Column.from_pylist(
                picked, f.dtype.wrap_nullable()
                if any(v is None for v in picked) else f.dtype)
        k = int(mask.sum())
        names, vals_cols = [], []
        for f in table.schema.fields:  # full schema; missing cols -> NULL
            names.append(f.name)
            vals_cols.append(given.get(
                f.name.lower(),
                Column.from_pylist([f.default] * k, f.dtype.wrap_nullable())))
        insert_blocks.append(DataBlock(names, vals_cols, k))

    # ---- rewrite the table in one commit
    survivors = DataBlock(list(out_cols.keys()), list(out_cols.values()),
                          tgt_block.num_rows).filter(keep)
    pieces = [survivors] + insert_blocks
    pieces = [p for p in pieces if p.num_rows]
    if pieces:
        # normalize column order via append's schema projection
        merged = pieces[0]
        for p in pieces[1:]:
            merged = DataBlock.concat([
                merged, DataBlock(merged.names,
                                  [p.column(n) for n in merged.names],
                                  p.num_rows)])
        table.append(merged, overwrite=True)
    else:
        table.truncate()
    n_inserted = sum(b.num_rows for b in insert_blocks)
    return n_updated, n_deleted, n_inserted
