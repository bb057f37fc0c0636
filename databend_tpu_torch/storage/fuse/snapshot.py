"""Immutable snapshot metadata: BlockMeta -> SegmentInfo -> TableSnapshot.

Analog of the reference's fuse table meta chain (reference:
src/query/storages/common/table_meta/src/meta/v4/snapshot.rs and
segment.rs): a snapshot lists segments; a segment lists blocks with
statistics. All immutable JSON files; commits only swap the snapshot
pointer in the meta service (OCC), giving time travel for free.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .statistics import ColumnStats, VectorStats


def new_uuid() -> str:
    return uuid.uuid4().hex


@dataclass
class BlockMeta:
    location: str  # relative to table dir, e.g. _b/{uuid}.parquet
    row_count: int
    block_size: int  # bytes on disk
    col_stats: Dict[str, ColumnStats] = field(default_factory=dict)
    # index name -> {"location": ..., "size": int, "stats": {...}}
    vector_indexes: Dict[str, dict] = field(default_factory=dict)
    inverted_indexes: Dict[str, dict] = field(default_factory=dict)
    bloom_index: Optional[dict] = None
    ngram_index: Optional[dict] = None
    cluster_id: Optional[int] = None
    # aggregating index name -> {"location": ..., "size": int}
    # (reference TableIndexType::Aggregating; per-block materialized
    # aggregate partials)
    agg_indexes: Dict[str, dict] = field(default_factory=dict)
    # EE virtual columns: {"location": sidecar parquet,
    #  "columns": [{"name","source","path","type"}]} (reference
    # virtual_column_builder.rs)
    virtual_column: Optional[dict] = None

    def to_dict(self):
        return {
            "location": self.location,
            "row_count": self.row_count,
            "block_size": self.block_size,
            "col_stats": {k: v.to_dict() for k, v in self.col_stats.items()},
            "vector_indexes": self.vector_indexes,
            "inverted_indexes": self.inverted_indexes,
            "bloom_index": self.bloom_index,
            "ngram_index": self.ngram_index,
            "cluster_id": self.cluster_id,
            "agg_indexes": self.agg_indexes,
            **({"virtual_column": self.virtual_column}
               if self.virtual_column else {}),
        }

    @staticmethod
    def from_dict(d):
        return BlockMeta(
            d["location"], d["row_count"], d["block_size"],
            {k: ColumnStats.from_dict(v) for k, v in d.get("col_stats", {}).items()},
            d.get("vector_indexes", {}), d.get("inverted_indexes", {}),
            d.get("bloom_index"), d.get("ngram_index"), d.get("cluster_id"),
            d.get("agg_indexes", {}), d.get("virtual_column"))

    def vector_stats_for(self, index_name: str) -> Optional[VectorStats]:
        vi = self.vector_indexes.get(index_name)
        if vi and vi.get("stats"):
            return VectorStats.from_dict(vi["stats"])
        return None


@dataclass
class SegmentInfo:
    blocks: List[BlockMeta]
    summary: Dict[str, ColumnStats] = field(default_factory=dict)
    row_count: int = 0

    def __post_init__(self):
        if self.row_count == 0:
            self.row_count = sum(b.row_count for b in self.blocks)
        if not self.summary and self.blocks:
            names = set()
            for b in self.blocks:
                names.update(b.col_stats)
            self.summary = {
                n: ColumnStats.merge([b.col_stats[n] for b in self.blocks if n in b.col_stats])
                for n in names}

    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks],
                "summary": {k: v.to_dict() for k, v in self.summary.items()},
                "row_count": self.row_count}

    @staticmethod
    def from_dict(d):
        return SegmentInfo([BlockMeta.from_dict(b) for b in d["blocks"]],
                           {k: ColumnStats.from_dict(v) for k, v in d.get("summary", {}).items()},
                           d.get("row_count", 0))


@dataclass
class TableSnapshot:
    snapshot_id: str
    segments: List[str]  # segment file locations relative to table dir
    row_count: int = 0
    block_count: int = 0
    index_size: int = 0
    prev_snapshot: Optional[str] = None
    timestamp: float = 0.0
    # schema at commit time (reference: TableSnapshot carries the schema)
    # — makes table dirs self-describing so ATTACH TABLE can open them
    schema: Optional[dict] = None
    # registry of variant virtual columns present in this snapshot's
    # blocks: {name: {"source","path","type"}} — read by the binder's
    # get()-rewrite (reference: virtual column metas in the snapshot)
    virtual_columns: Optional[dict] = None

    def to_dict(self):
        d = {
            "snapshot_id": self.snapshot_id,
            "segments": self.segments,
            "row_count": self.row_count,
            "block_count": self.block_count,
            "index_size": self.index_size,
            "prev_snapshot": self.prev_snapshot,
            "timestamp": self.timestamp,
        }
        if self.schema is not None:
            d["schema"] = self.schema
        if self.virtual_columns:
            d["virtual_columns"] = self.virtual_columns
        return d

    @staticmethod
    def from_dict(d):
        return TableSnapshot(d["snapshot_id"], d["segments"], d.get("row_count", 0),
                             d.get("block_count", 0), d.get("index_size", 0),
                             d.get("prev_snapshot"), d.get("timestamp", 0.0),
                             d.get("schema"), d.get("virtual_columns"))


def write_json(path: str, payload: dict) -> None:
    from ..operator import OPERATOR
    OPERATOR.write_bytes(path, json.dumps(payload).encode("utf-8"))


def read_json(path: str) -> dict:
    from ..operator import OPERATOR
    return json.loads(OPERATOR.read_bytes(path).decode("utf-8"))
