"""K-means vector clustering for CLUSTER BY (vector_col).

Reference semantics (src/query/storages/common/index/src/kmeans.rs:42-277 +
src/query/storages/fuse/src/operations/common/processors/
transform_vector_cluster.rs:29-211): deterministic seeding, batches capped
at 64 clusters / 262,144 rows, rows re-sorted by (cluster_id, distance to
own centroid) before block split so per-block centroid/radius stats are
tight and the vector stats pruner can drop most blocks.

Lloyd's iteration is a distance matmul + argmin + a one-hot matmul for the
(sum, count) reduction, as in the JAX package; here it runs eagerly on
torch on ``backend.device()``, in full f32 (``backend`` turns TF32 off).
The one-hot matmul keeps the centroid sums deterministic, where
``index_add_`` on the card would add in the order its atomics land.
Determinism comes from an LCG-seeded initial centroid choice, mirroring the
reference's LCG sampling (kmeans.rs:94).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import backend

MAX_CLUSTERS = 64          # reference: TransformVectorCluster batches
MAX_BATCH_ROWS = 262_144   # 64 clusters / <=262,144 rows


def _lcg_indices(n: int, k: int, seed: int = 0x2545F491) -> np.ndarray:
    """Deterministic distinct sample of k row indices (LCG like the
    reference's choose_initial_centroids, kmeans.rs:94-118)."""
    out = []
    seen = set()
    state = seed & 0xFFFFFFFF
    while len(out) < min(k, n):
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        idx = state % n
        if idx not in seen:
            seen.add(idx)
            out.append(idx)
    return np.asarray(out, dtype=np.int64)


def _lloyd(x: torch.Tensor, init: torch.Tensor, iters: int = 10
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """iters rounds of Lloyd's on x's device. x [n,d] f32, init [k,d] f32.
    Returns (centroids [k,d], assignments [n] int64, dist_to_own [n])."""
    k = init.shape[0]
    xx = torch.sum(x * x, dim=1)  # [n]

    def dist2(cent):
        cc = torch.sum(cent * cent, dim=1)
        xc = x @ cent.T
        return torch.clamp_min(xx[:, None] - 2.0 * xc + cc[None, :], 0.0)

    cent = init
    for _ in range(iters):
        assign = torch.argmin(dist2(cent), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # [n,k]
        sums = onehot.T @ x
        cnt = torch.sum(onehot, dim=0)
        cent = torch.where(cnt[:, None] > 0,
                           sums / torch.clamp_min(cnt[:, None], 1.0), cent)
    d2 = dist2(cent)
    assign = torch.argmin(d2, dim=1)
    own = torch.sqrt(torch.gather(d2, 1, assign[:, None])[:, 0])
    return cent, assign, own


class KMeans:
    """Deterministic k-means (the reference's KMeans facade, kmeans.rs:42)."""

    def __init__(self, k: int, iters: int = 10):
        self.k = min(k, MAX_CLUSTERS)
        self.iters = iters

    def compute(self, vectors: np.ndarray):
        """Returns (centroids [k,d] f32, assignments [n] i64, dist [n] f32)."""
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        n = x.shape[0]
        k = min(self.k, n)
        if n == 0:
            return (np.zeros((0, x.shape[1]), np.float32),
                    np.zeros(0, np.int64), np.zeros(0, np.float32))
        init = x[_lcg_indices(n, k)]
        cent, assign, own = _lloyd(backend.to_device(x),
                                   backend.to_device(init), iters=self.iters)
        cent, assign, own = backend.to_numpy(
            [cent, assign.to(torch.int32), own])           # one copy
        return cent, assign.astype(np.int64), own


def cluster_sort_order(vectors: np.ndarray, k: int = MAX_CLUSTERS,
                       iters: int = 10) -> np.ndarray:
    """Row permutation sorting by (cluster_id, distance-to-own-centroid) —
    the reference's pack_vector_cluster_sort_key ordering
    (transform_vector_cluster.rs:141-211). Batches of MAX_BATCH_ROWS are
    clustered independently, exactly like the streaming transform."""
    n = vectors.shape[0]
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for start in range(0, n, MAX_BATCH_ROWS):
        end = min(start + MAX_BATCH_ROWS, n)
        batch = vectors[start:end]
        km = KMeans(min(k, max(1, len(batch))), iters)
        _, assign, own = km.compute(batch)
        perm = np.lexsort((own, assign)) + start
        order[pos:pos + len(perm)] = perm
        pos += len(perm)
    return order


def cluster_layout(vectors: np.ndarray, k: int = MAX_CLUSTERS,
                   iters: int = 10):
    """(row permutation, cluster run lengths) for cluster-ALIGNED block
    splitting: rows sort by (cluster, distance-to-centroid) with clusters
    ordered along their centroids' first principal axis, so adjacent
    clusters are spatially close and blocks packing several whole clusters
    keep tight centroid/radius stats (the routing prune's food —
    reference vector_stat_score_domain). Batched at MAX_BATCH_ROWS like
    the reference TransformVectorCluster."""
    n = vectors.shape[0]
    order = np.empty(n, dtype=np.int64)
    runs = []
    pos = 0
    for start in range(0, n, MAX_BATCH_ROWS):
        end = min(start + MAX_BATCH_ROWS, n)
        batch = np.ascontiguousarray(vectors[start:end], np.float32)
        km = KMeans(min(k, max(1, len(batch))), iters)
        cent, assign, own = km.compute(batch)
        kk = cent.shape[0]
        # order clusters by a nearest-neighbor centroid walk so adjacent
        # clusters are mutually CLOSE in the full space (a 1-D projection
        # scatters high-dim modes); packed blocks then union only nearby
        # cells and keep small radii
        if kk > 1:
            d2 = ((cent[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            visited = np.zeros(kk, np.bool_)
            walk = [0]
            visited[0] = True
            for _ in range(kk - 1):
                row = d2[walk[-1]].copy()
                row[visited] = np.inf
                nxt = int(np.argmin(row))
                walk.append(nxt)
                visited[nxt] = True
            rank = np.empty(kk, np.int64)
            rank[np.asarray(walk)] = np.arange(kk)
            cluster_key = rank[assign]
        else:
            cluster_key = assign
        perm = np.lexsort((own, cluster_key)) + start
        order[pos:pos + len(perm)] = perm
        pos += len(perm)
        counts = np.bincount(cluster_key, minlength=kk)
        runs.extend(int(c) for c in counts if c > 0)
    return order, runs
