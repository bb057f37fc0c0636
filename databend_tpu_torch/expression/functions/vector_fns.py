"""Vector SQL functions: the reference ``expression/functions/vector_fns.py``
with the device branch of ``_rowwise`` on torch."""

from ..._reference import exec_reference
from ... import backend

exec_reference(globals(), "expression/functions/vector_fns.py")


def _rowwise(a, b, metric, arg_types):
    av = _vec_payload(a, arg_types[0])  # noqa: F821 (reference source)
    bv = _vec_payload(b, arg_types[1])  # noqa: F821
    if av.shape[0] >= _DEVICE_THRESHOLD:  # noqa: F821
        from ...ops.distance import rowwise_distance
        return backend.to_numpy(rowwise_distance(
            backend.to_device(av), backend.to_device(bv), metric))
    return _np_rowwise(av, bv, metric)  # noqa: F821
