"""Math scalar functions (reference: src/query/functions/src/scalars/math.rs)."""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import Float64, Int64
from .registry import scalar_function


def _num1(name, ret=Float64):
    def resolve(arg_types):
        if len(arg_types) != 1:
            raise SemanticError(f"{name} expects 1 arg")
        t = arg_types[0].remove_nullable()
        if not t.is_numeric():
            raise SemanticError(f"{name} expects numeric, got {t}")
        return ret
    return resolve


def _register_unary(name, fn, ret=Float64, aliases=()):
    @scalar_function(name, _num1(name, ret), aliases=list(aliases))
    def _k(a, out_dtype=None, **kw):
        with np.errstate(all="ignore"):
            return fn(np.asarray(a, np.float64)).astype(out_dtype.numpy_dtype())
    return _k


_register_unary("sqrt", np.sqrt)
_register_unary("cbrt", np.cbrt)


@scalar_function("factorial", _num1("factorial", Int64))
def _factorial(a, out_dtype=None, **kw):
    n = np.asarray(a, np.int64)
    if (n > 20).any():
        from ...errors import BadArguments
        raise BadArguments("factorial argument must be at most 20")
    out = np.ones_like(n)
    for k in range(2, int(n.max(initial=1)) + 1):
        out = np.where(n >= k, out * k, out)
    return out
_register_unary("exp", np.exp)
_register_unary("ln", np.log)
_register_unary("log2", np.log2)
_register_unary("log10", np.log10, aliases=["log"])
_register_unary("sin", np.sin)
_register_unary("cos", np.cos)
_register_unary("tan", np.tan)
_register_unary("asin", np.arcsin)
_register_unary("acos", np.arccos)
_register_unary("atan", np.arctan)
_register_unary("degrees", np.degrees)
_register_unary("radians", np.radians)
_register_unary("ceil", np.ceil, ret=Int64, aliases=["ceiling"])
_register_unary("floor", np.floor, ret=Int64)
_register_unary("sign", np.sign, ret=Int64)


def _abs_resolver(arg_types):
    t = arg_types[0].remove_nullable()
    if not t.is_numeric():
        raise SemanticError(f"abs expects numeric, got {t}")
    return t


@scalar_function("abs", _abs_resolver)
def _abs(a, **kw):
    return np.abs(a)


def _round_resolver(arg_types):
    if len(arg_types) not in (1, 2):
        raise SemanticError("round expects 1-2 args")
    return Float64


@scalar_function("round", _round_resolver)
def _round(a, digits=None, **kw):
    # half-away-from-zero (reference semantics: Rust f64::round), NOT
    # numpy's banker's rounding — round(2.5) = 3, round(-2.5) = -3
    a = np.asarray(a, np.float64)
    d = 0 if digits is None else int(np.asarray(digits).flat[0])
    scale = 10.0 ** d
    scaled = a * scale
    return np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) / scale


@scalar_function("truncate", _round_resolver)
def _truncate(a, digits=None, **kw):
    a = np.asarray(a, np.float64)
    d = 0 if digits is None else int(np.asarray(digits).flat[0])
    f = 10.0 ** d
    return np.trunc(a * f) / f


def _pow_resolver(arg_types):
    if len(arg_types) != 2:
        raise SemanticError("pow expects 2 args")
    return Float64


@scalar_function("pow", _pow_resolver, aliases=["power"])
def _pow(a, b, **kw):
    with np.errstate(all="ignore"):
        return np.power(np.asarray(a, np.float64), np.asarray(b, np.float64))


@scalar_function("atan2", _pow_resolver)
def _atan2(a, b, **kw):
    return np.arctan2(np.asarray(a, np.float64), np.asarray(b, np.float64))


@scalar_function("pi", lambda arg_types: Float64)
def _pi(n_rows=None, **kw):
    return np.full(n_rows, np.pi, np.float64)


def _sleep_resolver(arg_types):
    if len(arg_types) != 1 or not arg_types[0].remove_nullable().is_numeric():
        raise SemanticError("sleep expects one numeric argument")
    return Int64


@scalar_function("sleep", _sleep_resolver)
def _sleep(a, out_dtype=None, n_rows=1, **kw):
    """Blocks the query for N seconds, once (not per row) — reference
    scalars/other.rs sleep(), capped at 300s like the reference."""
    import time as _time
    secs = float(np.asarray(a).flat[0]) if np.asarray(a).size else 0.0
    if secs < 0 or secs > 300:
        from ...errors import BadArguments
        raise BadArguments("sleep seconds must be in [0, 300]")
    _time.sleep(secs)
    return np.zeros(max(int(n_rows), 1), np.int64)[:int(n_rows)] \
        if n_rows else np.zeros(1, np.int64)
