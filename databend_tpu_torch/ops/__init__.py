from .distance import (
    pairwise_distance,
    cosine_distance,
    l2_distance,
    l2_distance_squared,
    l1_distance,
    inner_product,
    normalize,
    VALID_METRICS,
)
from .topk import topk_smallest, chunked_topk_smallest, merge_topk, brute_force_topk

__all__ = [
    "pairwise_distance",
    "cosine_distance",
    "l2_distance",
    "l2_distance_squared",
    "l1_distance",
    "inner_product",
    "normalize",
    "VALID_METRICS",
    "topk_smallest",
    "chunked_topk_smallest",
    "merge_topk",
    "brute_force_topk",
]
