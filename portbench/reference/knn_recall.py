"""Recall@k of served approximate KNN answers against the float64 exact
truth, as ann-benchmarks counts it (``knn_threshold``): a served row is a
hit when its true distance is within the true k-th distance. ann-benchmarks
adds an epsilon of 1e-3 to the threshold; here it is 0.

The truth is ``knn.Exact``'s: float64 distances worked out again from the
generated rows and queries on the device, in blocks of queries, with TF32
off. The served answers are only read to be judged: each served row's
distance is worked out again from its id.

The numbers compared (``judge``), each against the configuration's limit:

- ``malformed``: queries whose rows are missing, extra, out of range,
  repeated or not finite (and stray rows of no query), as ``knn`` counts
  them;
- ``recall_shortfall``: 1 less the mean recall@k of the well-formed
  queries (0: every served row within its query's true k-th distance);
- ``dist_err``: the widest gap between a served distance and the float32
  of the served row's true distance, over the float32 of the true k-th
  (as ``knn``'s).

Equal distances at the k-th place may be broken either way: any row at
the k-th distance is a hit.
"""

from __future__ import annotations

import numpy as np

from .knn import Exact, well_formed


def recall(served_d2: np.ndarray, kth_d2: np.ndarray) -> np.ndarray:
    """``[M]`` recall@k of each query: the share of its served rows whose
    true squared distance (``served_d2 [M, k]``) is within its true k-th
    (``kth_d2 [M]``)."""
    return (served_d2 <= kth_d2[:, None]).mean(1)


def judge(batches: list, data: dict, config: dict, device):
    """(the numbers of the module doc, the count of failed queries: the
    malformed ones) over every batch in ``batches`` (``pool``: the
    positions asked in the data's ``queries``; ``query_index``, ``id``,
    ``d``: the served block's columns), against the data's ``rows`` and
    the configuration's ``k``."""
    rows, queries, k = data["rows"], data["queries"], config["k"]
    ref = Exact(rows, device)
    _, ref_d2 = ref.top_k(queries, k)
    kth = ref_d2[:, -1]
    pools, ids, ds, bad = [], [], [], 0
    for b in batches:
        ok, i, d, stray = well_formed(b, k, len(rows))
        bad += int((~ok).sum()) + stray
        pools.append(np.asarray(b["pool"])[ok])
        ids.append(i[ok])
        ds.append(d[ok])
    pool = np.concatenate(pools)
    out = {"malformed": bad, "answered": int(len(pool))}
    if not len(pool):
        out.update(recall_shortfall=1.0, dist_err=float("inf"))
        return out, bad
    ids, d = np.concatenate(ids), np.concatenate(ds)
    served = ref.squared(queries, pool, ids)
    out["recall_shortfall"] = float(1.0 - recall(served, kth[pool]).mean())
    true_d = np.sqrt(served).astype(np.float32)
    kth_d = np.sqrt(np.maximum(kth, 1e-300)).astype(np.float32)
    out["dist_err"] = float(
        (np.abs(d.astype(np.float64) - true_d) / kth_d[pool][:, None]).max())
    del ref
    return out, bad
