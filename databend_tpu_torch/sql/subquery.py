"""Uncorrelated subquery support.

Scalar / IN / EXISTS subqueries are planned and executed eagerly at bind
time and folded into constants (the reference hoists them into join plans;
uncorrelated evaluation is semantically identical and the common case for
the warehouse workloads here). Correlated subqueries raise.
"""

from __future__ import annotations

from ..errors import SemanticError
from ..expression.evaluator import infer_literal_type
from ..expression.expr import Constant, Func
from ..types import Boolean
from . import ast as A


def _run(session, query: A.Query, ctes):
    from ..pipeline.executor import execute_plan
    from .binder import Binder
    from .optimizer import optimize
    plan = optimize(Binder(session).bind_query(query, ctes), session)
    return execute_plan(plan), plan


def bind_subquery_expr(session, e, binder, ctes):
    if isinstance(e, A.ScalarSubquery):
        block, plan = _run(session, e.query, ctes)
        if block.num_columns() != 1:
            raise SemanticError("scalar subquery must return one column")
        if block.num_rows > 1:
            raise SemanticError("scalar subquery returned more than one row")
        val = block.column_at(0).get(0) if block.num_rows else None
        dtype = plan.output_fields()[0].dtype
        return Constant(val, dtype.wrap_nullable() if val is None else dtype)
    if isinstance(e, A.Exists):
        block, _ = _run(session, e.query, ctes)
        val = block.num_rows > 0
        return Constant(val != e.negated, Boolean)
    if isinstance(e, A.InSubquery):
        block, _ = _run(session, e.query, ctes)
        if block.num_columns() != 1:
            raise SemanticError("IN subquery must return one column")
        vals = [v for v in block.column_at(0).to_pylist() if v is not None]
        x = binder.bind(e.expr)
        res = Func("in_set", [x, Constant(vals, infer_literal_type(vals or [0]))],
                   Boolean if not x.dtype.is_nullable() else Boolean.wrap_nullable())
        return binder._func("not", [res]) if e.negated else res
    raise SemanticError(f"unsupported subquery {type(e).__name__}")
