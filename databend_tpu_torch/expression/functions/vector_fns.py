"""Vector SQL functions: cosine_distance, l1/l2_distance, inner_product,
vector_dims, vector_norm.

(reference: src/query/functions/src/scalars/vector.rs:57-455 registers them
over ARRAY(FLOAT32/64) and VECTOR(n); scalar math in
src/common/vector/src/distance.rs)

Row-aligned forms (two columns of equal length). Large batches route to
the jitted TPU kernel in ops.distance.rowwise_distance; the numpy fallback
keeps tiny blocks off the device (dispatch overhead would dominate).
"""

from __future__ import annotations

import numpy as np

from ...errors import SemanticError
from ...types import ArrayType, Float32, UInt64, VectorType
from .registry import scalar_function

# below this row count the numpy path wins (no device dispatch)
_DEVICE_THRESHOLD = 4096


def _vec_payload(payload, arg_type):
    """Normalize an ARRAY(FLOAT)/VECTOR payload to a [N, d] float32 ndarray."""
    from ...errors import SemanticError as _SE
    t = arg_type.remove_nullable()
    if isinstance(t, VectorType):
        return np.asarray(payload, dtype=np.float32)
    if isinstance(payload, tuple):  # array column payload: (offsets, child)
        offsets, child = payload
        lens = np.diff(offsets)
        if len(lens) == 0:
            return np.zeros((0, 1), np.float32)
        if not (lens == lens[0]).all():
            raise _SE("array arguments to vector functions must have equal lengths")
        flat = np.asarray(child.data, dtype=np.float32)
        return flat.reshape(len(lens), int(lens[0]))
    # object ndarray of python lists (ARRAY literal path)
    rows = [np.asarray(v, dtype=np.float32) for v in payload]
    return np.stack(rows) if rows else np.zeros((0, 1), np.float32)


def _distance_resolver(name):
    def resolve(arg_types):
        if len(arg_types) != 2:
            raise SemanticError(f"{name} expects 2 args")
        for t in arg_types:
            t = t.remove_nullable()
            if not isinstance(t, (VectorType, ArrayType)):
                raise SemanticError(f"{name} expects vector/array args, got {t}")
        a, b = (t.remove_nullable() for t in arg_types)
        if isinstance(a, VectorType) and isinstance(b, VectorType) and a.dim != b.dim:
            raise SemanticError(f"{name}: vector dims differ ({a.dim} vs {b.dim})")
        return Float32
    return resolve


def _np_rowwise(a, b, metric):
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    if a.shape[1] != b.shape[1]:
        raise SemanticError(f"vector dims differ ({a.shape[1]} vs {b.shape[1]})")
    if metric == "cosine":
        num = (a * b).sum(-1)
        den = np.sqrt((a * a).sum(-1) * (b * b).sum(-1))
        return (1.0 - num / np.maximum(den, 1e-30)).astype(np.float32)
    if metric == "l2":
        return np.sqrt(((a - b) ** 2).sum(-1)).astype(np.float32)
    if metric == "l1":
        return np.abs(a - b).sum(-1).astype(np.float32)
    if metric == "ip":
        return (a * b).sum(-1).astype(np.float32)
    raise ValueError(metric)


def _rowwise(a, b, metric, arg_types):
    av = _vec_payload(a, arg_types[0])
    bv = _vec_payload(b, arg_types[1])
    if av.shape[0] >= _DEVICE_THRESHOLD:
        from ... import backend
        from ...ops.distance import rowwise_distance
        return backend.to_numpy(rowwise_distance(
            backend.to_device(av), backend.to_device(bv), metric))
    return _np_rowwise(av, bv, metric)


@scalar_function("cosine_distance", _distance_resolver("cosine_distance"))
def _cosine(a, b, arg_types=None, **kw):
    return _rowwise(a, b, "cosine", arg_types)


@scalar_function("l2_distance", _distance_resolver("l2_distance"))
def _l2(a, b, arg_types=None, **kw):
    return _rowwise(a, b, "l2", arg_types)


@scalar_function("l1_distance", _distance_resolver("l1_distance"))
def _l1(a, b, arg_types=None, **kw):
    return _rowwise(a, b, "l1", arg_types)


@scalar_function("inner_product", _distance_resolver("inner_product"))
def _ip(a, b, arg_types=None, **kw):
    return _rowwise(a, b, "ip", arg_types)


def _vec1_resolver(name, ret):
    def resolve(arg_types):
        if len(arg_types) != 1:
            raise SemanticError(f"{name} expects 1 arg")
        t = arg_types[0].remove_nullable()
        if not isinstance(t, (VectorType, ArrayType)):
            raise SemanticError(f"{name} expects a vector, got {t}")
        return ret
    return resolve


@scalar_function("vector_dims", _vec1_resolver("vector_dims", UInt64))
def _dims(a, arg_types=None, n_rows=None, **kw):
    v = _vec_payload(a, arg_types[0])
    return np.full(v.shape[0], v.shape[1], np.uint64)


@scalar_function("vector_norm", _vec1_resolver("vector_norm", Float32))
def _norm(a, arg_types=None, **kw):
    v = _vec_payload(a, arg_types[0])
    return np.sqrt((v.astype(np.float32) ** 2).sum(-1)).astype(np.float32)
