"""Array functions (reference: src/query/functions/src/scalars/array.rs)."""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import ArrayType, Boolean, Float64, Int64, Null, UInt64
from .registry import scalar_function


def _as_lists(payload):
    """ARRAY payload: (offsets, child Column) tuple or object ndarray of lists."""
    if isinstance(payload, tuple):
        offsets, child = payload
        vals = child.to_pylist()
        return [vals[int(offsets[i]): int(offsets[i + 1])] for i in range(len(offsets) - 1)]
    return [list(v) if v is not None else [] for v in payload]


def _arr_resolver(name, n_args, ret):
    def resolve(arg_types):
        if len(arg_types) != n_args:
            raise SemanticError(f"{name} expects {n_args} args")
        t = arg_types[0].remove_nullable()
        if not isinstance(t, ArrayType):
            raise SemanticError(f"{name} expects an array, got {t}")
        return ret
    return resolve


@scalar_function("array_length", _arr_resolver("array_length", 1, UInt64), aliases=["array_size"])
def _array_length(a, **kw):
    return np.array([len(v) for v in _as_lists(a)], np.uint64)


@scalar_function("array_contains", _arr_resolver("array_contains", 2, Boolean), aliases=["contains"])
def _array_contains(a, item, **kw):
    items = item.to_pylist() if hasattr(item, "to_pylist") else np.asarray(item).tolist()
    return np.array([x in v for v, x in zip(_as_lists(a), items)], np.bool_)


def _get_resolver(arg_types):
    if len(arg_types) != 2:
        raise SemanticError("array_get expects 2 args")
    t = arg_types[0].remove_nullable()
    if isinstance(t, ArrayType):
        return t.inner.wrap_nullable()
    raise SemanticError(f"get expects an array, got {t}")


@scalar_function("array_get", _get_resolver, null_policy="custom")
def _get(payloads, validities, arg_types=None, n_rows=None, **kw):
    from ..column import Column
    lists = _as_lists(payloads[0])
    idx = np.asarray(payloads[1]).astype(np.int64)
    inner = arg_types[0].remove_nullable().inner
    out = []
    for i, v in enumerate(lists):
        j = int(idx[i] if idx.ndim else idx) - 1  # SQL arrays are 1-based
        out.append(v[j] if 0 <= j < len(v) else None)
    col = Column.from_pylist(out, inner.wrap_nullable())
    return col.data, (col.validity if col.validity is not None
                      else np.ones(n_rows, np.bool_))


@scalar_function("array_sum", _arr_resolver("array_sum", 1, Float64))
def _array_sum(a, **kw):
    return np.array([float(np.sum(v)) if len(v) else 0.0 for v in _as_lists(a)], np.float64)


@scalar_function("array_avg", _arr_resolver("array_avg", 1, Float64))
def _array_avg(a, **kw):
    return np.array([float(np.mean(v)) if len(v) else 0.0 for v in _as_lists(a)], np.float64)


@scalar_function("array_max", _arr_resolver("array_max", 1, Float64))
def _array_max(a, **kw):
    return np.array([float(np.max(v)) if len(v) else 0.0 for v in _as_lists(a)], np.float64)


@scalar_function("array_min", _arr_resolver("array_min", 1, Float64))
def _array_min(a, **kw):
    return np.array([float(np.min(v)) if len(v) else 0.0 for v in _as_lists(a)], np.float64)


@scalar_function("array_distinct", _arr_resolver("array_distinct", 1, ArrayType(Float64)))
def _array_distinct(a, **kw):
    out = []
    for v in _as_lists(a):
        seen = []
        for x in v:
            if x not in seen:
                seen.append(x)
        out.append(seen)
    return np.array(out, dtype=object)
