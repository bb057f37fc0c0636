"""MAP(K, V) functions.

Reference: src/query/functions/src/scalars/map.rs — map(), map_keys,
map_values, map_size, map_contains_key, map_cat, map_delete, map_insert,
map_pick, and element access. Maps are per-row python dicts (host-side;
they never enter device kernels).
"""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import ArrayType, Boolean, MapType, String, UInt64
from ..column import Column, StringData
from .registry import scalar_function


def _rows(payload):
    """Per-row python values from a column payload of any shape."""
    if isinstance(payload, StringData):
        return payload.to_pylist()
    if isinstance(payload, tuple) and len(payload) == 2 \
            and isinstance(payload[1], Column):
        offs = np.asarray(payload[0])
        vals = payload[1].to_pylist()
        return [vals[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    if isinstance(payload, np.ndarray):
        return list(payload) if payload.dtype == object \
            else payload.tolist()
    return list(payload)


def _map_t(arg_types, i=0):
    t = arg_types[i].remove_nullable()
    if not isinstance(t, MapType):
        raise SemanticError(f"expected MAP argument, got {t.sql_name()}")
    return t


def _reg(name, fn, n_args, resolve):
    @scalar_function(name, resolve, null_policy="custom")
    def _k(payloads, validities, arg_types, n_rows):
        cols = [_rows(p) for p in payloads]
        out, valid = [], np.ones(n_rows, np.bool_)
        for i in range(n_rows):
            if any(v is not None and not v[i] for v in validities):
                out.append(None)
                valid[i] = False
                continue
            r = fn(*[c[i] for c in cols], arg_types=arg_types)
            if r is None:
                out.append(None)
                valid[i] = False
            else:
                out.append(r)
        ret = resolve(arg_types).remove_nullable()
        col = Column.from_pylist(out, ret.wrap_nullable())
        return col.data, valid if not valid.all() else col.validity


def _fix_key(k):
    return k


# map(keys_array, values_array)
def _map_resolver(ts):
    if len(ts) != 2:
        raise SemanticError("map expects 2 arguments")
    kt = ts[0].remove_nullable()
    vt = ts[1].remove_nullable()
    if not isinstance(kt, ArrayType) or not isinstance(vt, ArrayType):
        raise SemanticError("map expects two arrays")
    return MapType(kt.inner, vt.inner)


_reg("map", lambda ks, vs, arg_types: dict(zip(ks, vs)), 2, _map_resolver)

_reg("map_keys", lambda m, arg_types: list(m.keys()), 1,
     lambda ts: ArrayType(_map_t(ts).key))
_reg("map_values", lambda m, arg_types: list(m.values()), 1,
     lambda ts: ArrayType(_map_t(ts).value))
_reg("map_size", lambda m, arg_types: len(m), 1, lambda ts: (
    _map_t(ts), UInt64)[1])


def _contains_resolver(ts):
    _map_t(ts)
    return Boolean


_reg("map_contains_key", lambda m, k, arg_types: k in m, 2,
     _contains_resolver)


def _get_resolver(ts):
    return _map_t(ts).value.wrap_nullable()


_reg("map_get", lambda m, k, arg_types: m.get(k), 2, _get_resolver)


def _cat_resolver(ts):
    t = _map_t(ts)
    _map_t(ts, 1)
    return t


_reg("map_cat", lambda a, b, arg_types: {**a, **b}, 2, _cat_resolver)
_reg("map_delete", lambda m, k, arg_types: {x: v for x, v in m.items()
                                            if x != k}, 2,
     lambda ts: _map_t(ts))


def _insert_resolver(ts):
    return _map_t(ts)


@scalar_function("map_insert", _insert_resolver, null_policy="custom")
def _map_insert(payloads, validities, arg_types, n_rows):
    ms = _rows(payloads[0])
    ks = _rows(payloads[1])
    vs = _rows(payloads[2])
    out, valid = [], np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if validities[0] is not None and not validities[0][i]:
            out.append(None)
            valid[i] = False
            continue
        m = dict(ms[i])
        m[ks[i]] = vs[i]
        out.append(m)
    col = Column.from_pylist(out, _map_t(arg_types).wrap_nullable())
    return col.data, valid if not valid.all() else col.validity


def _pick_resolver(ts):
    return _map_t(ts)


@scalar_function("map_pick", _pick_resolver, null_policy="custom")
def _map_pick(payloads, validities, arg_types, n_rows):
    ms = _rows(payloads[0])
    keys = [_rows(p) for p in payloads[1:]]
    out, valid = [], np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if validities[0] is not None and not validities[0][i]:
            out.append(None)
            valid[i] = False
            continue
        want = []
        for kc in keys:
            k = kc[i]
            want.extend(k if isinstance(k, list) else [k])
        out.append({x: v for x, v in ms[i].items() if x in set(want)})
    col = Column.from_pylist(out, _map_t(arg_types).wrap_nullable())
    return col.data, valid if not valid.all() else col.validity


def _tuple_get_resolver(ts):
    from ...types import TupleType
    t = ts[0].remove_nullable()
    if not isinstance(t, TupleType):
        raise SemanticError("tuple_get expects a tuple")
    # the binder validated the index constant; element type resolved there
    return t.fields[0].wrap_nullable() if t.fields else String.wrap_nullable()


@scalar_function("tuple_get", _tuple_get_resolver, null_policy="custom")
def _tuple_get(payloads, validities, arg_types, n_rows):
    rows = _rows(payloads[0])
    idxs = _rows(payloads[1])
    out, valid = [], np.ones(n_rows, np.bool_)
    for i in range(n_rows):
        if validities[0] is not None and not validities[0][i]:
            out.append(None)
            valid[i] = False
            continue
        t = rows[i]
        k = int(idxs[i]) - 1
        if t is None or not 0 <= k < len(t):
            out.append(None)
            valid[i] = False
        else:
            out.append(t[k])
    tt = arg_types[0].remove_nullable()
    k0 = int(idxs[0]) - 1 if idxs else 0
    et = tt.fields[k0] if 0 <= k0 < len(tt.fields) else String
    col = Column.from_pylist(out, et.wrap_nullable())
    return col.data, valid if not valid.all() else col.validity
