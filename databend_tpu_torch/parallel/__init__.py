"""Multi-chip distributed execution: mesh construction + collective query ops."""

from .mesh import (DP_AXIS, SHARD_AXIS, corpus_sharding, make_mesh,
                   query_sharding, replicated, shard_rows)
from .distributed import (sharded_brute_force_topk, sharded_kmeans_step,
                          sharded_partial_agg, sharded_search_step)

__all__ = [
    "DP_AXIS", "SHARD_AXIS", "make_mesh", "corpus_sharding", "query_sharding",
    "replicated", "shard_rows", "sharded_brute_force_topk",
    "sharded_kmeans_step", "sharded_partial_agg", "sharded_search_step",
]
