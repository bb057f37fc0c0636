"""Arithmetic functions: +, -, *, /, %, div, negate.

(reference: src/query/functions/src/scalars/arithmetic.rs)
"""

from __future__ import annotations

import numpy as np

from ...errors import BadArguments, SemanticError
from ...types import Float64, Int64, NumberType, common_super_type
from .registry import scalar_function


def _numeric_binary_resolver(name):
    def resolve(arg_types):
        if len(arg_types) != 2:
            raise SemanticError(f"{name} expects 2 args")
        a, b = (t.remove_nullable() for t in arg_types)
        # DATE +/- int -> DATE; TIMESTAMP +/- int -> TIMESTAMP (reference
        # date arithmetic: days / microseconds)
        from ...types.datatype import DateType, TimestampType
        if name in ("plus", "minus"):
            for x, y in ((a, b), (b, a)):
                if isinstance(x, (DateType, TimestampType)) \
                        and isinstance(y, NumberType) and y.is_integer():
                    if name == "minus" and x is b:
                        break  # int - date is not defined
                    return x
        if not (a.is_numeric() and b.is_numeric()):
            raise SemanticError(f"{name} expects numeric args, got {a}, {b}")
        out = common_super_type(a, b)
        # int ops widen to i64 to dodge overflow (reference promotes likewise)
        if isinstance(out, NumberType) and out.is_integer() and out.bit_width() < 64:
            out = Int64
        return out
    return resolve


def _div_resolver(arg_types):
    _numeric_binary_resolver("divide")(arg_types)
    return Float64


def _with_out_dtype(op):
    def kernel(a, b, arg_types=None, out_dtype=None, **kw):
        from ...types.datatype import DateType, TimestampType
        if isinstance(out_dtype, (DateType, TimestampType)):
            # date/timestamp +/- integer stays in the stored unit
            # (days / microseconds)
            nd = out_dtype.numpy_dtype()
            return op(np.asarray(a).astype(nd), np.asarray(b).astype(nd))
        af = a.astype(out_dtype.numpy_dtype()) if hasattr(a, "astype") else a
        bf = b.astype(out_dtype.numpy_dtype()) if hasattr(b, "astype") else b
        return op(af, bf)
    return kernel


scalar_function("plus", _numeric_binary_resolver("plus"))(_with_out_dtype(np.add))
scalar_function("minus", _numeric_binary_resolver("minus"))(_with_out_dtype(np.subtract))
scalar_function("multiply", _numeric_binary_resolver("multiply"))(_with_out_dtype(np.multiply))


def _valid_both(validities, n):
    """AND of arg validities (True where the row is actually computed)."""
    valid = None
    for v in validities:
        if v is not None:
            valid = v if valid is None else (valid & v)
    return valid if valid is not None else np.ones(n, np.bool_)


def _division_kernel(name, op, resolve_out):
    """divide/mod/div with NULL-aware zero checks: a zero divisor only
    errors on rows where BOTH args are valid — NULL payload slots are
    zero-filled and must not trip the check (reference error text)."""
    def kernel(payloads, validities, arg_types=None, n_rows=0, **kw):
        a = np.asarray(payloads[0])
        b = np.asarray(payloads[1])
        valid = _valid_both(validities, n_rows)
        if ((b == 0) & valid).any():
            raise BadArguments("divided by zero")  # reference error text
        out_np = resolve_out(arg_types).remove_nullable().numpy_dtype()
        bsafe = np.where(b == 0, 1, b)
        out = op(a.astype(out_np), bsafe.astype(out_np)).astype(out_np)
        v = None
        for x in validities:
            if x is not None:
                v = x.copy() if v is None else (v & x)
        return out, v
    return kernel


scalar_function("divide", _div_resolver, null_policy="custom")(
    _division_kernel("divide", np.divide, _div_resolver))
scalar_function("modulo", _numeric_binary_resolver("modulo"),
                null_policy="custom", aliases=["mod"])(
    _division_kernel("modulo", np.mod,
                     _numeric_binary_resolver("modulo")))
scalar_function("div", _numeric_binary_resolver("div"),
                null_policy="custom", aliases=["intdiv"])(
    _division_kernel("div", np.floor_divide,
                     _numeric_binary_resolver("div")))


def _div0_kernel(payloads, validities, arg_types=None, n_rows=0, **kw):
    """div0(a, b): a/b with 0 where b = 0 (reference arithmetic.rs)."""
    a = np.asarray(payloads[0], np.float64)
    b = np.asarray(payloads[1], np.float64)
    out = np.divide(a, np.where(b == 0, 1.0, b))
    out = np.where(b == 0, 0.0, out)
    v = _valid_both(validities, n_rows)
    return out, (None if v.all() else v)


def _divnull_kernel(payloads, validities, arg_types=None, n_rows=0, **kw):
    """divnull(a, b): a/b, NULL where b = 0 (reference arithmetic.rs)."""
    a = np.asarray(payloads[0], np.float64)
    b = np.asarray(payloads[1], np.float64)
    out = np.divide(a, np.where(b == 0, 1.0, b))
    v = _valid_both(validities, n_rows) & (b != 0)
    return out, v


scalar_function("div0", lambda ts: Float64, null_policy="custom")(
    _div0_kernel)
scalar_function("divnull", lambda ts: Float64.wrap_nullable(),
                null_policy="custom")(_divnull_kernel)


@scalar_function("bit_not", lambda ts: Int64)
def _bit_not(a, out_dtype=None, **kw):
    return ~np.asarray(a, np.int64)


# bit operations (reference scalars/arithmetic.rs bit_* family)
def _bit_kernel(op):
    def kernel(a, b, out_dtype=None, **kw):
        return op(np.asarray(a, np.int64), np.asarray(b, np.int64))
    return kernel


for _n, _op in (("bit_and", np.bitwise_and), ("bit_or", np.bitwise_or),
                ("bit_xor", np.bitwise_xor),
                ("bit_shift_left", np.left_shift),
                ("bit_shift_right", np.right_shift)):
    scalar_function(_n, _numeric_binary_resolver(_n))(_bit_kernel(_op))


def _neg_resolver(arg_types):
    t = arg_types[0].remove_nullable()
    if not t.is_numeric():
        raise SemanticError(f"negate expects numeric, got {t}")
    if isinstance(t, NumberType) and not t.is_signed():
        return Int64
    return t


@scalar_function("negate", _neg_resolver)
def _negate(a, out_dtype=None, **kw):
    return (-a.astype(out_dtype.numpy_dtype()))
