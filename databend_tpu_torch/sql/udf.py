"""Lambda UDF expansion.

Reference analog: CREATE FUNCTION (lambda form) handled by
interpreter_user_defined_function + UDF rewrite in the binder. Here UDFs
are stored as (params, body text) in the meta KV and expanded by a pure
AST rewrite before binding, so they work in any expression position
(SELECT, WHERE, scripts, COPY transforms) with zero executor support.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from ..errors import SemanticError, UnknownFunction
from . import ast as A

MAX_DEPTH = 16  # self/mutually-recursive UDF guard


def _substitute(e: A.Expr, mapping: Dict[str, A.Expr]) -> A.Expr:
    if isinstance(e, A.ColumnRef) and e.table is None \
            and e.name.lower() in mapping:
        return mapping[e.name.lower()]
    return _rewrite_children(e, lambda c: _substitute(c, mapping))


def _rewrite_children(node: Any, fn) -> Any:
    if not dataclasses.is_dataclass(node):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, A.Expr):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, list):
            nl = [fn(x) if isinstance(x, A.Expr) else _rewrite_children(x, fn)
                  for x in v]
            if any(a is not b for a, b in zip(nl, v)):
                changes[f.name] = nl
        elif dataclasses.is_dataclass(v):
            nv = _rewrite_children(v, fn)
            if nv is not v:
                changes[f.name] = nv
    if changes:
        return dataclasses.replace(node, **changes)
    return node


def expand_udfs(node: Any, udfs: Dict[str, dict], depth: int = 0) -> Any:
    """Recursively inline UDF calls anywhere in a statement AST."""
    if depth > MAX_DEPTH:
        raise SemanticError("UDF expansion too deep (recursive definition?)")

    def visit(e: A.Expr) -> A.Expr:
        e = _rewrite_children(e, visit)
        if isinstance(e, A.FunctionCall) and e.name.lower() in udfs:
            udf = udfs[e.name.lower()]
            if isinstance(udf, dict) and udf.get("kind") == "external":
                return e  # resolved via the scalar registry, not inlined
            params: List[str] = udf["params"]
            if len(e.args) != len(params):
                raise SemanticError(
                    f"{e.name}() expects {len(params)} args, got {len(e.args)}")
            from .parser import Parser
            body = Parser(udf["body_text"]).parse_expr()
            mapping = {p.lower(): a for p, a in zip(params, e.args)}
            inlined = _substitute(body, mapping)
            return expand_udfs(inlined, udfs, depth + 1)
        return e

    if isinstance(node, A.Expr):
        return visit(node)
    return _rewrite_children(node, visit)
