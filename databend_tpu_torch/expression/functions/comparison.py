"""Comparison + boolean logic functions.

(reference: src/query/functions/src/scalars/comparison.rs)

Boolean AND/OR use SQL three-valued logic and are registered with
``null_policy="custom"`` so NULL short-circuits correctly
(TRUE OR NULL = TRUE, FALSE AND NULL = FALSE).
"""

from __future__ import annotations

import re

import numpy as np

from ...errors import SemanticError
from ...types import Boolean, StringType
from ..column import StringData
from .registry import scalar_function


def _comparable(payload):
    if isinstance(payload, StringData):
        return payload.as_object_array()
    return payload


def _cmp_resolver(name):
    def resolve(arg_types):
        if len(arg_types) != 2:
            raise SemanticError(f"{name} expects 2 args")
        return Boolean
    return resolve


def _eq_const_bytes(sd: StringData, const: str) -> np.ndarray:
    """``col = 'const'`` without decoding: UTF-8 byte equality IS string
    equality — filter by row length, then compare candidate byte rows in
    one [n_cand, L] vectorized pass."""
    b = np.frombuffer(const.encode("utf-8"), np.uint8)
    L = len(b)
    row_len = sd.offsets[1:] - sd.offsets[:-1]
    out = row_len == L
    if L and out.any():
        cand = np.flatnonzero(out)
        starts = sd.offsets[:-1][cand]
        mat = sd.data[starts[:, None] + np.arange(L)]
        out[cand] = (mat == b).all(axis=1)
    return out


def _dict_pair(sd: StringData):
    """(dictionary, codes) for a coded string column; builds codes for
    large columns (amortized: blocks are cached and re-compared)."""
    dv = sd.dict_view()
    if dv is None and len(sd) >= 65536 \
            and getattr(sd, "_const_value", None) is None:
        if sd.codes() is not None:
            dv = sd.dict_view()
    return dv


def _register_cmp(name, op, aliases=()):
    @scalar_function(name, _cmp_resolver(name), aliases=list(aliases))
    def _k(a, b, **kw):
        if name in ("eq", "noteq"):
            for x, y in ((a, b), (b, a)):
                if isinstance(x, StringData) and isinstance(y, StringData):
                    const = getattr(y, "_const_value", None)
                    if const is not None and len(x) >= 1024:
                        dv = _dict_pair(x)
                        if dv is not None:
                            # compare once per DISTINCT value, then gather
                            eq = _eq_const_bytes(dv[0], const)[dv[1]]
                        else:
                            eq = _eq_const_bytes(x, const)
                        return eq if name == "eq" else ~eq
        a, b = _comparable(a), _comparable(b)
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray) \
                and a.dtype.kind in "iuf" and b.dtype.kind in "iuf":
            a = a.astype(np.float64) if a.dtype != b.dtype else a
            b = b.astype(np.float64) if a.dtype != b.dtype else b
        return np.asarray(op(a, b), dtype=np.bool_)
    return _k


_register_cmp("eq", lambda a, b: a == b)
_register_cmp("noteq", lambda a, b: a != b)
_register_cmp("lt", lambda a, b: a < b)
_register_cmp("lte", lambda a, b: a <= b)
_register_cmp("gt", lambda a, b: a > b)
_register_cmp("gte", lambda a, b: a >= b)


@scalar_function("eq_null_safe", _cmp_resolver("eq_null_safe"),
                 null_policy="custom")
def _eq_null_safe(payloads, validities, arg_types, n_rows):
    """<=> (IS NOT DISTINCT FROM): NULL <=> NULL is TRUE, never NULL."""
    a = _comparable(payloads[0])
    b = _comparable(payloads[1])
    va, vb = validities
    va = np.ones(n_rows, np.bool_) if va is None else np.asarray(va, bool)
    vb = np.ones(n_rows, np.bool_) if vb is None else np.asarray(vb, bool)
    eq = np.asarray(a == b, np.bool_)
    out = np.where(va & vb, eq, ~va & ~vb)
    return out.astype(np.bool_), None


def _extreme_resolver(name):
    def resolve(arg_types):
        if not arg_types:
            raise SemanticError(f"{name} expects at least 1 arg")
        from ...types import common_super_type
        out = arg_types[0]
        for t in arg_types[1:]:
            out = common_super_type(out, t)
        return out
    return resolve


def _register_extreme(name, reduce_fn):
    @scalar_function(name, _extreme_resolver(name))
    def _k(*args, **kw):
        cols = [_comparable(a) for a in args]
        out = cols[0]
        for c in cols[1:]:
            out = reduce_fn(out, c)
        return out
    return _k


_register_extreme("greatest", lambda a, b: np.where(a >= b, a, b))
_register_extreme("least", lambda a, b: np.where(a <= b, a, b))


def _bool_resolver(name, n=2):
    def resolve(arg_types):
        if len(arg_types) != n:
            raise SemanticError(f"{name} expects {n} args")
        return Boolean
    return resolve


@scalar_function("and", _bool_resolver("and"), null_policy="custom")
def _and(payloads, validities, **kw):
    a, b = (np.asarray(p, dtype=np.bool_) for p in payloads)
    va, vb = validities
    out = a & b
    if va is None and vb is None:
        return out, None
    va = va if va is not None else np.ones(len(a), np.bool_)
    vb = vb if vb is not None else np.ones(len(b), np.bool_)
    # NULL unless: both valid, or one side is a valid FALSE
    validity = (va & vb) | (va & ~a) | (vb & ~b)
    out = out & va & vb  # garbage-safe payload
    return out, validity


@scalar_function("or", _bool_resolver("or"), null_policy="custom")
def _or(payloads, validities, **kw):
    a, b = (np.asarray(p, dtype=np.bool_) for p in payloads)
    va, vb = validities
    out = a | b
    if va is None and vb is None:
        return out, None
    va = va if va is not None else np.ones(len(a), np.bool_)
    vb = vb if vb is not None else np.ones(len(b), np.bool_)
    validity = (va & vb) | (va & a) | (vb & b)
    out = (a & va) | (b & vb)
    return out, validity


@scalar_function("xor", _bool_resolver("xor"))
def _xor(a, b, **kw):
    return np.asarray(a, np.bool_) ^ np.asarray(b, np.bool_)


@scalar_function("not", _bool_resolver("not", 1))
def _not(a, **kw):
    return ~np.asarray(a, dtype=np.bool_)


def _like_to_regex(pattern: str) -> str:
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
    return "^" + "".join(out) + "$"


def _str2_resolver(name):
    def resolve(arg_types):
        if len(arg_types) != 2:
            raise SemanticError(f"{name} expects 2 args")
        if not isinstance(arg_types[1].remove_nullable(), StringType):
            raise SemanticError(f"{name} pattern must be a string")
        return Boolean
    return resolve


def _test_unique(payload, test):
    """Evaluate a per-row predicate once per UNIQUE string value via the
    native factorizer codes; None = not applicable (reference: the
    low-cardinality dictionary fast path)."""
    if not isinstance(payload, StringData):
        return None
    n = len(payload)
    dv = payload.dict_view()
    if dv is not None:
        # dictionary already built: always cheaper than a per-row pass
        duniq = dv[0].as_object_array()
        uniq_res = np.fromiter((test(v) for v in duniq), np.bool_,
                               len(duniq))
        return uniq_res[dv[1]]
    codes = payload.codes()
    if codes is None or n < 1024:
        return None
    n_uniq = int(codes.max()) + 1 if n else 0
    if n_uniq * 4 > n:  # high cardinality: dedup won't pay
        return None
    # first-occurrence row per code (reversed scatter: first write wins)
    first = np.empty(n_uniq, np.int64)
    first[codes[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
    uniq_res = np.fromiter((test(payload.get(int(r))) for r in first),
                           np.bool_, n_uniq)
    return uniq_res[codes]


def _apply_pattern(a, pattern_payload, flags):
    pats = _comparable(pattern_payload)
    if len(set(pats.tolist())) == 1:  # constant pattern fast path
        rx = re.compile(_like_to_regex(pats[0]), flags)
        fast = _test_unique(a, lambda v: rx.match(v or "") is not None)
        if fast is not None:
            return fast
        vals = _comparable(a)
        return np.fromiter((rx.match(v or "") is not None for v in vals),
                           np.bool_, len(vals))
    vals = _comparable(a)
    return np.fromiter(
        (re.match(_like_to_regex(p), v or "", flags) is not None for v, p in zip(vals, pats)),
        np.bool_, len(vals))


@scalar_function("like", _str2_resolver("like"))
def _like(a, pattern, **kw):
    return _apply_pattern(a, pattern, 0)


@scalar_function("ilike", _str2_resolver("ilike"))
def _ilike(a, pattern, **kw):
    return _apply_pattern(a, pattern, re.I)


def _in_set_resolver(arg_types):
    if len(arg_types) != 2:
        raise SemanticError("in_set expects 2 args")
    return Boolean


@scalar_function("in_set", _in_set_resolver)
def _in_set(a, items, **kw):
    """Membership in a constant list (IN-subquery folding).
    ``items`` is a broadcast ARRAY constant: every row holds the same list."""
    if isinstance(items, tuple):  # array column payload: (offsets, child)
        offsets, child = items
        s = set(child.to_pylist()[: int(offsets[1])])
    else:
        lst = items.tolist() if hasattr(items, "tolist") else list(items)
        s = set(lst[0] if lst and isinstance(lst[0], (list, tuple)) else lst)
    fs = None
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in s) and s:
        # numeric membership also matches string/variant digits
        # ('20' IN (select 20)) — reference variant-vs-scalar coercion
        fs = {float(v) for v in s}

    def member(v):
        if v in s:
            return True
        if fs is not None and isinstance(v, str):
            try:
                return float(v) in fs
            except ValueError:
                return False
        return False

    if isinstance(a, StringData):
        dv = _dict_pair(a)
        if dv is not None:  # membership once per DISTINCT value
            mm = np.fromiter((member(v) for v in dv[0].as_object_array()),
                             np.bool_, len(dv[0]))
            return mm[dv[1]]
    vals = _comparable(a)
    if isinstance(vals, np.ndarray) and vals.dtype.kind in "iuf" \
            and fs is not None:
        # vectorized membership: one np.isin (sort-based) instead of a
        # Python loop per row — TPC-H q18's 150k-key IN list at C speed
        return np.isin(vals, np.fromiter((float(v) for v in s), np.float64,
                                         len(s)))
    if isinstance(vals, np.ndarray) and vals.dtype.kind not in "OU" \
            and fs is None:
        import pandas as pd
        return pd.Index(vals).isin(list(s)).astype(np.bool_)
    arr = vals.tolist() if hasattr(vals, "tolist") else list(vals)
    return np.fromiter((member(v) for v in arr), np.bool_, len(arr))


@scalar_function("regexp", _str2_resolver("regexp"), aliases=["rlike"])
def _regexp(a, pattern, **kw):
    pats = _comparable(pattern)
    if len(set(pats.tolist())) == 1:
        rx = re.compile(pats[0])
        fast = _test_unique(a, lambda v: rx.search(v or "") is not None)
        if fast is not None:
            return fast
        vals = _comparable(a)
        return np.fromiter((rx.search(v or "") is not None for v in vals), np.bool_, len(vals))
    vals = _comparable(a)
    return np.fromiter(
        (re.search(p, v or "") is not None for v, p in zip(vals, pats)),
        np.bool_, len(vals))
