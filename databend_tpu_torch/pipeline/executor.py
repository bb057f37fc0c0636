"""Plan executor: the reference ``pipeline/executor.py`` with its vector
device seam, ``_brute_force_scores``, on torch."""

import numpy as np

from .._reference import exec_reference
from .. import backend

exec_reference(globals(), "pipeline/executor.py")


def _brute_force_scores(table, meta, info, block):
    """Score every row of the block (reference generate_scores path,
    vector_index_pruner.rs:305-398)."""
    from ..ops.distance import pairwise_distance
    metric = info.func_name.replace("_distance", "")
    x = table.device_vectors(meta, info.column, normalized=False)
    q = backend.to_device(np.asarray(info.query_values, np.float32)[None, :])
    d = pairwise_distance(q, x, metric)
    # device arrays pad to the quantum grid; keep only real rows
    return backend.to_numpy(d[0, :block.num_rows])
