"""HNSW vector index, torch-native: dense graph build + batched beam search."""

from .build import build_hnsw
from .graph import HnswGraph
from .search import hnsw_search

__all__ = ["HnswGraph", "build_hnsw", "hnsw_search"]
