"""Distributed query execution over a device mesh (port of
``databend_tpu/parallel/distributed.py``).

Equivalents of the reference's exchange kinds (reference:
schedulers/fragments/fragmenter.rs:238-266 — Normal/Merge/Expansive) and
distributed pruning (read_partitions.rs:263-290), as per-shard phases and
collectives over :class:`~.mesh.Mesh` (``mesh.py``):

  * distributed top-k   = per-shard scan+score+select, then `all_gather`
    over the shard axis + one final k-select — the ordered MergeExchange +
    bounded-merge-sort of the reference (exchange_sorting.rs);
  * distributed aggregate = per-shard partial aggregate + `psum`;
  * k-means step        = per-shard assign + `psum` of (sum, count) — the
    training-style write-path step (transform_vector_cluster.rs) sharded.

Corpus values are row-sharded on mesh axis ``shard`` and query batches
optionally on ``dp``. Inputs and outputs are
:class:`~.mesh.ShardedTensor`s. Each process runs the per-shard phases of
the positions it owns; a result the reference replicates over the shard
axis is computed once per process from the gathered values (the same bits
on every process), on its first position's device, and copied to each
other device of it that holds it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.distance import pairwise_distance
from ..ops.topk import chunked_topk_smallest, topk_smallest_lowest_index
from .mesh import (DP_AXIS, SHARD_AXIS, P, ShardedTensor, first_local,
                   from_blocks, gather, per_shard, pmax, pmin, psum, unzip)


def local_topk(q_l, x_l, k: int, metric: str, rows_per_shard: int,
               shard_idx: int, chunk_rows: int, bf16: bool,
               n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's phase of the sharded top-k: its rows scored and
    selected with global ids. Pad rows (global id >= n_valid) are masked to
    +inf BEFORE the local selection — no pad value is +inf-safe for every
    metric."""
    cd = torch.bfloat16 if bf16 else torch.float32
    return chunked_topk_smallest(
        q_l, x_l, min(k, rows_per_shard), metric,
        chunk_rows=min(chunk_rows, rows_per_shard), compute_dtype=cd,
        base_id=shard_idx * rows_per_shard, n_valid=n_valid)


def merge_gathered(all_v: torch.Tensor, all_i: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final k-select over the gathered ``[S, B, k_l]`` lists, in shard
    order: equal distances keep ascending global ids, because the shards
    hold ascending row ranges."""
    b = all_v.shape[1]
    cat_v = all_v.permute(1, 0, 2).reshape(b, -1)
    cat_i = all_i.permute(1, 0, 2).reshape(b, -1)
    out_v, pos = topk_smallest_lowest_index(cat_v, k)
    return out_v, torch.gather(cat_i, 1, pos).to(torch.int32)


def sharded_brute_force_topk(mesh, q: ShardedTensor, x: ShardedTensor,
                             k: int, metric: str = "l2",
                             chunk_rows: int = 131072,
                             bf16: bool = False,
                             n_valid: Optional[int] = None
                             ) -> Tuple[ShardedTensor, ShardedTensor]:
    """Exact distributed top-k: `[B,d]` queries x row-sharded `[N,d]` corpus.

    Each shard scores its rows and selects a local `[B,k]` with global row
    ids; shards then `all_gather` the `(dist, id)` pairs and every shard
    reduces to the global `[B,k]`. This is the reference's per-node pruning
    + ordered merge exchange path (SURVEY §3.3 distributed variant).

    ``q`` is dp-sharded over the query batch, replicated over ``shard``;
    returns (dists [B,k] f32, ids [B,k] int32) with the same dp sharding.
    """
    n_total = x.shape[0]
    s = mesh.shape[SHARD_AXIS]
    rows_per_shard = n_total // s
    nv = n_total if n_valid is None else int(n_valid)
    dp = mesh.shape[DP_AXIS]
    rows_v, rows_i = [], []
    for i in range(dp):
        local = per_shard(
            lambda j, q_l, x_l: local_topk(q_l, x_l, k, metric,
                                           rows_per_shard, j, chunk_rows,
                                           bf16, nv),
            q.shards(i), x.shards(i))
        loc_v, loc_i = unzip(local, 2)
        # every shard's merge is the same: one a process, replicated below
        v, ids = merge_gathered(gather(loc_v), gather(loc_i), k)
        rows_v.append(v)
        rows_i.append(ids)
    shape = (q.shape[0], k)
    spec = P(DP_AXIS, None)
    return (from_blocks(mesh, spec, shape, lambda i, j: rows_v[i]),
            from_blocks(mesh, spec, shape, lambda i, j: rows_i[i]))


def sharded_partial_agg(mesh, x: ShardedTensor, op: str = "sum"
                        ) -> ShardedTensor:
    """Distributed aggregate over a row-sharded column: per-shard partial +
    `psum`/`pmax`/`pmin` (the Merge aggregate exchange)."""
    parts = x.shards()
    if op == "sum":
        out = psum(per_shard(lambda _, p: torch.sum(p, dim=0), parts))
    elif op == "max":
        out = pmax(per_shard(lambda _, p: torch.max(p, dim=0).values, parts))
    elif op == "min":
        out = pmin(per_shard(lambda _, p: torch.min(p, dim=0).values, parts))
    elif op == "count":
        out = psum(per_shard(lambda _, p: torch.tensor(
            p.shape[0], dtype=torch.int32, device=p.device), parts))
    else:
        raise ValueError(op)
    out = first_local(out)
    return from_blocks(mesh, P(), tuple(out.shape), lambda i, j: out)


def sharded_kmeans_step(mesh, x: ShardedTensor, centroids: ShardedTensor,
                        metric: str = "l2_sq"
                        ) -> Tuple[ShardedTensor, ShardedTensor]:
    """One distributed Lloyd's iteration over a row-sharded corpus.

    Per shard: distance matmul to centroids + argmin assignment (the first
    minimum) + one-hot partial (sum, count) as a full-f32 product;
    cross-shard: `psum`. This is the write-path k-means clustering of the
    reference (kmeans.rs:94-120, transform_vector_cluster.rs:29-141) — the
    database's "training step".

    Returns (new_centroids [C,d], counts [C]); empty clusters keep their
    old centroid.
    """
    c = centroids.shape[0]

    def partial(j, x_l, cent):
        d = pairwise_distance(x_l, cent, metric)                 # [n_l, C]
        assign = torch.argmin(d, dim=1)                          # [n_l]
        onehot = torch.nn.functional.one_hot(assign, c).float()  # [n_l, C]
        return onehot.T @ x_l.float(), torch.sum(onehot, dim=0)  # [C, d], [C]

    psums, pcnts = unzip(per_shard(partial, x.shards(),
                                   centroids.shards()), 2)
    gsums = first_local(psum(psums))
    gcnt = first_local(psum(pcnts))
    cent = first_local(centroids.shards())
    new = torch.where(gcnt[:, None] > 0,
                      gsums / torch.clamp_min(gcnt[:, None], 1.0), cent)
    return (from_blocks(mesh, P(), tuple(new.shape), lambda i, j: new),
            from_blocks(mesh, P(), tuple(gcnt.shape), lambda i, j: gcnt))


def sharded_search_step(mesh, q: ShardedTensor, x: ShardedTensor,
                        centroids: ShardedTensor, k: int, metric: str = "l2",
                        bf16: bool = True):
    """The flagship multi-device step: distributed exact top-k search fused
    with a distributed k-means maintenance step (scan + score + k-select +
    merge, plus the write-path clustering update). Exercises dp x shard
    sharding, all_gather and psum — the full collective surface of the
    serving + ingest paths."""
    dists, ids = sharded_brute_force_topk(mesh, q, x, k, metric, bf16=bf16)
    new_cent, counts = sharded_kmeans_step(mesh, x, centroids)
    return dists, ids, new_cent, counts
