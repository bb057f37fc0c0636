"""Standalone predicate evaluator for the batched serving fast paths.

The prepared-statement servers (service/prepared.py) pin a table snapshot
in corpus row order and need WHERE conjuncts evaluated host-side ONCE per
snapshot — outside the generic bind/optimize/execute pipeline whose
per-query overhead the fast path exists to avoid. This is a small
AST-walking evaluator over the snapshot's concatenated columns with
proper SQL three-valued logic (reference: the filter transform,
src/query/expression/src/filter/ — NULL comparisons are UNKNOWN, and a
WHERE keeps a row only when the predicate is TRUE).

Ternary encoding: int8 0 = FALSE, 1 = UNKNOWN, 2 = TRUE, so Kleene
AND = min, OR = max, NOT = 2 - x.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from ..sql import ast as A

FALSE, UNKNOWN, TRUE = np.int8(0), np.int8(1), np.int8(2)

_CMP_OPS = {"=", "==", "!=", "<>", "<", "<=", ">", ">="}


class Unsupported(Exception):
    """Raised when the predicate shape is outside the fast-path grammar;
    callers fall back to the generic pipeline."""


def _like_regex(pattern: str) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _values(block, e: A.Expr, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate a value expression -> (values, null_mask). Strings come
    back as object arrays; numerics as their numpy dtype."""
    if isinstance(e, A.Literal):
        v = e.value
        if v is None:
            return (np.zeros(n, np.float64), np.ones(n, bool))
        if isinstance(v, bool):
            arr = np.full(n, v)
        elif isinstance(v, (int, float)):
            arr = np.full(n, v, np.float64 if isinstance(v, float)
                          else np.int64)
        elif isinstance(v, str):
            arr = np.full(n, v, dtype=object)
        else:
            raise Unsupported(f"literal {type(v).__name__}")
        return arr, np.zeros(n, bool)
    if isinstance(e, A.ColumnRef):
        col = None
        if block.has_column(e.name):
            col = block.column(e.name)
        else:
            for nm, c in block.items():
                if nm.lower() == e.name.lower():
                    col = c
                    break
        if col is None:
            raise Unsupported(f"unknown column {e.name!r}")
        nulls = (~col.validity if col.validity is not None
                 else np.zeros(len(col), bool))
        data = col.data
        if isinstance(data, np.ndarray):
            if data.ndim != 1:
                raise Unsupported("vector column in predicate")
            return data, nulls
        if hasattr(data, "as_object_array"):       # StringData
            return data.as_object_array(), nulls
        raise Unsupported(f"column payload {type(data).__name__}")
    if isinstance(e, A.Cast) and not e.is_try:
        # pass-through casts the parser inserts around literals
        return _values(block, e.expr, n)
    raise Unsupported(f"value expr {type(e).__name__}")


def _compare(l, ln, r, rn, op: str) -> np.ndarray:
    both_str = (l.dtype == object) or (r.dtype == object)
    if both_str and not (l.dtype == object and r.dtype == object):
        raise Unsupported("string/number comparison")
    with np.errstate(invalid="ignore"):
        if op in ("=", "=="):
            t = l == r
        elif op in ("!=", "<>"):
            t = l != r
        elif op == "<":
            t = l < r
        elif op == "<=":
            t = l <= r
        elif op == ">":
            t = l > r
        elif op == ">=":
            t = l >= r
        else:
            raise Unsupported(f"comparison {op!r}")
    out = np.where(np.asarray(t, bool), TRUE, FALSE).astype(np.int8)
    out[ln | rn] = UNKNOWN
    return out


def eval_ternary(block, e: A.Expr) -> np.ndarray:
    """Predicate -> int8 ternary array (FALSE/UNKNOWN/TRUE) over the
    block's rows. Raises Unsupported outside the fast-path grammar."""
    n = len(block)
    if isinstance(e, A.BinaryOp):
        op = e.op.upper()
        if op == "AND":
            return np.minimum(eval_ternary(block, e.left),
                              eval_ternary(block, e.right))
        if op == "OR":
            return np.maximum(eval_ternary(block, e.left),
                              eval_ternary(block, e.right))
        if op in ("LIKE", "NOT LIKE"):
            if not isinstance(e.right, A.Literal) \
                    or not isinstance(e.right.value, str):
                raise Unsupported("LIKE pattern must be a constant")
            v, nulls = _values(block, e.left, n)
            if v.dtype != object:
                raise Unsupported("LIKE on non-string")
            rx = _like_regex(e.right.value)
            hit = np.fromiter((rx.match(s) is not None for s in v),
                              count=n, dtype=bool)
            if op == "NOT LIKE":
                hit = ~hit
            out = np.where(hit, TRUE, FALSE).astype(np.int8)
            out[nulls] = UNKNOWN
            return out
        if e.op in _CMP_OPS:
            l, ln = _values(block, e.left, n)
            r, rn = _values(block, e.right, n)
            return _compare(l, ln, r, rn, e.op)
        raise Unsupported(f"operator {e.op!r}")
    if isinstance(e, A.UnaryOp) and e.op.upper() == "NOT":
        return (TRUE - eval_ternary(block, e.operand) + FALSE).astype(np.int8)
    if isinstance(e, A.InList):
        v, nulls = _values(block, e.expr, n)
        acc = np.full(n, FALSE, np.int8)
        saw_null_item = False
        for item in e.items:
            if isinstance(item, A.Literal) and item.value is None:
                saw_null_item = True
                continue
            iv, inul = _values(block, item, n)
            acc = np.maximum(acc, _compare(v, nulls, iv, inul, "="))
        if saw_null_item:        # x IN (.., NULL) is UNKNOWN when unmatched
            acc = np.maximum(acc, UNKNOWN)
        acc[nulls] = UNKNOWN
        if e.negated:
            acc = (TRUE - acc + FALSE).astype(np.int8)
        return acc
    if isinstance(e, A.Between):
        lo = A.BinaryOp(">=", e.expr, e.low)
        hi = A.BinaryOp("<=", e.expr, e.high)
        t = np.minimum(eval_ternary(block, lo), eval_ternary(block, hi))
        return (TRUE - t + FALSE).astype(np.int8) if e.negated else t
    if isinstance(e, A.IsNull):
        v, nulls = _values(block, e.expr, n)
        hit = ~nulls if e.negated else nulls
        return np.where(hit, TRUE, FALSE).astype(np.int8)
    if isinstance(e, A.Literal) and isinstance(e.value, bool):
        return np.full(n, TRUE if e.value else FALSE, np.int8)
    raise Unsupported(f"predicate {type(e).__name__}")


def eval_mask(block, e: A.Expr) -> np.ndarray:
    """WHERE semantics: keep rows whose predicate is TRUE (not UNKNOWN)."""
    return eval_ternary(block, e) == TRUE


def split_conjuncts(e: Optional[A.Expr]) -> list:
    if e is None:
        return []
    if isinstance(e, A.BinaryOp) and e.op.upper() == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def referenced_columns(e, out=None) -> list:
    """Column names referenced anywhere in the expression (lowercased)."""
    if out is None:
        out = []
    if isinstance(e, A.ColumnRef):
        out.append(e.name.lower())
    elif isinstance(e, (list, tuple)):
        for x in e:
            referenced_columns(x, out)
    elif hasattr(e, "__dataclass_fields__"):
        for f in e.__dataclass_fields__:
            referenced_columns(getattr(e, f), out)
    return out
