"""Scan pushdown descriptors.

Analog of the reference's ``PushDownInfo`` (reference:
src/query/catalog/src/plan/pushdown.rs:167-207), including the vector and
inverted index infos the planner attaches after rewriting KNN / match()
queries (pushdown.rs:143-156; type_check/vector.rs:70-120).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class VectorIndexInfo:
    """KNN pushdown (reference: pushdown.rs:143-156)."""

    index_name: str
    column: str
    func_name: str  # cosine_distance | l1_distance | l2_distance
    query_values: List[float]
    options: dict = field(default_factory=dict)
    # True when query shape allows HNSW top-k prune (ASC order, no other
    # filter); False forces brute-force score generation
    topk_asc: bool = True


@dataclass
class InvertedIndexInfo:
    """Full-text search pushdown (reference: pushdown.rs:167+)."""

    index_name: str
    columns: List[str]
    query_text: str
    is_match: bool = True  # match() vs query() syntax
    fuzziness: Optional[int] = None
    operator: str = "OR"
    has_score: bool = False
    options: dict = field(default_factory=dict)


@dataclass
class Range:
    """Sort description entry."""

    column: str
    asc: bool = True
    nulls_first: bool = False


@dataclass
class PushDownInfo:
    projection: Optional[List[str]] = None  # column names to read
    filters: Any = None  # bound ScalarExpr
    limit: Optional[int] = None
    order_by: List[Range] = field(default_factory=list)
    vector_index: Optional[VectorIndexInfo] = None
    inverted_index: Optional[InvertedIndexInfo] = None
    # shard the exact-scan search over the device mesh when >1 device
    # (reference enable_distributed_pruning, settings_default.rs:1470)
    enable_distributed: bool = False
    # per-block KNN strategy (settings: vector_search_mode) and the auto-
    # mode exact-scan row ceiling: the exact scan beat HNSW at ef = 40 for
    # blocks up to 1,048,576 rows (NVIDIA H100 80GB HBM3, 700.00 W;
    # chip_smoke.py --gates), so the defaults equal settings.py's
    vector_search_mode: str = "auto"
    vector_exact_scan_max_rows: int = 1 << 20
    # corpora at or below this many rows are scored on the host (numpy):
    # the card's crossover is 65,536 rows (the host scan ahead at 4,096,
    # split at 16,384, behind 2.7-3.2x at 65,536; NVIDIA H100 80GB HBM3,
    # 700.00 W; chip_smoke.py --gates)
    vector_host_scan_max_rows: int = 1 << 16
    # allow the TopN block pruner (setting enable_top_n)
    enable_topn: bool = True
