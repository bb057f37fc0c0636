"""Conditional / null-handling functions: if, coalesce, is_null, ifnull, nullif.

(reference: src/query/functions/src/scalars/control.rs)
All registered with null_policy="custom" since they look at validity.
"""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import Boolean, common_super_type
from ..column import StringData
from .registry import scalar_function


def _select_payload(mask, a, b):
    """Elementwise select over payloads (handles StringData)."""
    if isinstance(a, StringData) or isinstance(b, StringData):
        al = a.to_pylist() if isinstance(a, StringData) else [str(v) for v in a.tolist()]
        bl = b.to_pylist() if isinstance(b, StringData) else [str(v) for v in b.tolist()]
        return StringData.from_pylist([x if m else y for m, x, y in zip(mask, al, bl)])
    if a.ndim == 2:  # vectors
        return np.where(mask[:, None], a, b)
    return np.where(mask, a, b)


def _if_resolver(arg_types):
    if len(arg_types) != 3:
        raise SemanticError("if expects 3 args")
    return common_super_type(arg_types[1], arg_types[2]).remove_nullable()


@scalar_function("if", _if_resolver, null_policy="custom", aliases=["iff"])
def _if(payloads, validities, **kw):
    cond, a, b = payloads
    vc, va, vb = validities
    cond = np.asarray(cond, np.bool_)
    if vc is not None:
        cond = cond & vc  # NULL condition -> else branch
    out = _select_payload(cond, a, b)
    if va is None and vb is None:
        return out, None
    n = len(cond)
    va = va if va is not None else np.ones(n, np.bool_)
    vb = vb if vb is not None else np.ones(n, np.bool_)
    return out, np.where(cond, va, vb)


def _coalesce_resolver(arg_types):
    if not arg_types:
        raise SemanticError("coalesce expects at least 1 arg")
    out = arg_types[0]
    for t in arg_types[1:]:
        out = common_super_type(out, t)
    return out.remove_nullable()


@scalar_function("coalesce", _coalesce_resolver, null_policy="custom")
def _coalesce(payloads, validities, **kw):
    n = len(payloads[0]) if not isinstance(payloads[0], StringData) else len(payloads[0])
    out = payloads[0]
    validity = validities[0] if validities[0] is not None else np.ones(n, np.bool_)
    for p, v in zip(payloads[1:], validities[1:]):
        need = ~validity
        if not need.any():
            break
        out = _select_payload(validity, out, p)
        validity = validity | (v if v is not None else np.ones(n, np.bool_))
    if validity.all():
        return out, None
    return out, validity


@scalar_function("ifnull", lambda ts: _coalesce_resolver(ts[:2]), null_policy="custom", aliases=["nvl"])
def _ifnull(payloads, validities, **kw):
    return _coalesce(payloads[:2], validities[:2], **kw)


def _is_null_resolver(arg_types):
    if len(arg_types) != 1:
        raise SemanticError("is_null expects 1 arg")
    return Boolean


@scalar_function("is_null", _is_null_resolver, null_policy="custom")
def _is_null(payloads, validities, n_rows=None, **kw):
    v = validities[0]
    if v is None:
        return np.zeros(n_rows, np.bool_), None
    return ~v, None


@scalar_function("is_not_null", _is_null_resolver, null_policy="custom")
def _is_not_null(payloads, validities, n_rows=None, **kw):
    v = validities[0]
    if v is None:
        return np.ones(n_rows, np.bool_), None
    return v.copy(), None


def _nullif_resolver(arg_types):
    if len(arg_types) != 2:
        raise SemanticError("nullif expects 2 args")
    return arg_types[0].remove_nullable()


@scalar_function("nullif", _nullif_resolver, null_policy="custom")
def _nullif(payloads, validities, n_rows=None, **kw):
    a, b = payloads
    va, vb = validities
    if isinstance(a, StringData):
        eq = np.array([x == y for x, y in zip(a.to_pylist(), b.to_pylist())], np.bool_)
    else:
        eq = np.asarray(a == b, np.bool_)
    if va is not None or vb is not None:
        va_ = va if va is not None else np.ones(n_rows, np.bool_)
        vb_ = vb if vb is not None else np.ones(n_rows, np.bool_)
        eq = eq & va_ & vb_
    validity = (~eq) if va is None else ((~eq) & va)
    return a, validity


# ---- nullability adapters (reference: to_nullable / remove_nullable /
# assume_not_null in scalars) -------------------------------------------
def _to_nullable_resolver(arg_types):
    if len(arg_types) != 1:
        raise SemanticError("to_nullable expects 1 arg")
    return arg_types[0].remove_nullable()


@scalar_function("to_nullable", _to_nullable_resolver, null_policy="custom")
def _to_nullable(payloads, validities, n_rows=None, **kw):
    v = validities[0]
    return payloads[0], (np.ones(n_rows, np.bool_) if v is None else v)


def _remove_nullable_resolver(arg_types):
    if len(arg_types) != 1:
        raise SemanticError("remove_nullable expects 1 arg")
    return arg_types[0].remove_nullable()


@scalar_function("remove_nullable", _remove_nullable_resolver,
                 null_policy="custom", aliases=["assume_not_null"])
def _remove_nullable(payloads, validities, n_rows=None, **kw):
    return payloads[0], None
