"""Per-block / per-segment column statistics.

Analog of the reference's statistics layer (reference:
src/query/storages/fuse/src/statistics/ + vector stats in
io/write/vector_index_writer.rs:491-607). Min/max/null-count feed range
pruning; vector centroid+radius feed the score-domain prune
(vector_index_pruner.rs:544-617).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ...expression import Column, DataBlock, StringData
from ...types import (ArrayType, Boolean, NumberType, StringType, VectorType)


@dataclass
class ColumnStats:
    min: object = None
    max: object = None
    null_count: int = 0
    in_memory_size: int = 0

    def to_dict(self):
        return {"min": self.min, "max": self.max, "null_count": self.null_count,
                "in_memory_size": self.in_memory_size}

    @staticmethod
    def from_dict(d):
        return ColumnStats(d.get("min"), d.get("max"), d.get("null_count", 0),
                           d.get("in_memory_size", 0))

    @staticmethod
    def merge(parts: List["ColumnStats"]) -> "ColumnStats":
        mins = [p.min for p in parts if p.min is not None]
        maxs = [p.max for p in parts if p.max is not None]
        return ColumnStats(
            min(mins) if mins else None,
            max(maxs) if maxs else None,
            sum(p.null_count for p in parts),
            sum(p.in_memory_size for p in parts))


@dataclass
class VectorStats:
    """Centroid + radius per metric (reference vector_index_writer.rs:571-607):
    for any query q, distance(q, x) for x in block lies within
    [d(q, centroid) - radius, d(q, centroid) + radius] for metrics obeying
    the triangle inequality (l1, l2); for dot/cosine the interval uses the
    norm bound instead."""

    centroid: List[float]
    radius: Dict[str, float]  # metric -> max distance(centroid, x)
    row_count: int

    def to_dict(self):
        return {"centroid": self.centroid, "radius": self.radius,
                "row_count": self.row_count}

    @staticmethod
    def from_dict(d):
        return VectorStats(d["centroid"], d["radius"], d["row_count"])


def column_stats(col: Column) -> ColumnStats:
    inner = col.dtype.remove_nullable()
    nulls = col.null_count()
    valid = col.validity
    if isinstance(inner, (NumberType,)) or inner in ():
        data = col.data if valid is None else col.data[valid]
        if len(data) == 0:
            return ColumnStats(None, None, nulls, col.data.nbytes)
        mn, mx = data.min(), data.max()
        return ColumnStats(_py(mn), _py(mx), nulls, col.data.nbytes)
    if isinstance(inner, StringType):
        size = int(col.data.offsets[-1]) if isinstance(col.data, StringData) else 0
        if isinstance(col.data, StringData):
            full = col.data.codes()
            if full is not None and len(full):
                # min/max over DISTINCT values only (native factorize +
                # decode of uniques — no per-row decode at ingest)
                import numpy as _np
                sel = full if valid is None else full[_np.asarray(valid, bool)]
                if not len(sel):
                    return ColumnStats(None, None, nulls, size)
                n_u = int(full.max()) + 1
                rep = _np.empty(n_u, _np.int64)
                rep[full[::-1]] = _np.arange(len(full) - 1, -1, -1)
                uniq = [col.data.get(int(rep[c])) for c in _np.unique(sel)]
                return ColumnStats(min(uniq)[:64], max(uniq)[:64], nulls,
                                   size)
        vals = [v for v in col.to_pylist() if v is not None]
        if not vals:
            return ColumnStats(None, None, nulls, size)
        # cap stored string bounds (reference trims long stats similarly)
        return ColumnStats(min(vals)[:64], max(vals)[:64], nulls, size)
    if inner == Boolean:
        data = col.data if valid is None else col.data[valid]
        if len(data) == 0:
            return ColumnStats(None, None, nulls, col.data.nbytes)
        return ColumnStats(bool(data.min()), bool(data.max()), nulls, col.data.nbytes)
    if isinstance(inner, VectorType):
        return ColumnStats(None, None, nulls, col.data.nbytes)
    from ...types import DecimalType, GeometryType
    if isinstance(inner, GeometryType):
        # bbox stats for spatial pruning (reference spatial_index.rs:77):
        # min = [xmin, ymin], max = [xmax, ymax] over any WKT geometry kind
        from ...expression import geometry as G
        box = None
        vals = col.to_pylist()
        for i, w in enumerate(vals):
            if valid is not None and not valid[i]:
                continue
            try:
                b = G.bbox(*G.parse_wkt(w))
            except Exception:
                continue
            if b is None:
                continue
            box = b if box is None else (min(box[0], b[0]), min(box[1], b[1]),
                                         max(box[2], b[2]), max(box[3], b[3]))
        if box is None:
            return ColumnStats(None, None, nulls, 0)
        return ColumnStats([box[0], box[1]], [box[2], box[3]], nulls, 0)
    if isinstance(inner, DecimalType):
        vals = ([v for v, ok in zip(col.data.tolist(), valid) if ok]
                if valid is not None else list(col.data.tolist()))
        if not vals:
            return ColumnStats(None, None, nulls, 16 * len(col))
        # stored as strings so the JSON snapshot stays exact
        return ColumnStats(str(min(vals)), str(max(vals)), nulls, 16 * len(col))
    # date/timestamp are numpy ints
    if isinstance(col.data, np.ndarray) and col.data.dtype.kind in "iu":
        data = col.data if valid is None else col.data[valid]
        if len(data) == 0:
            return ColumnStats(None, None, nulls, col.data.nbytes)
        return ColumnStats(int(data.min()), int(data.max()), nulls, col.data.nbytes)
    return ColumnStats(None, None, nulls, 0)


def _py(v):
    return v.item() if hasattr(v, "item") else v


def block_stats(block: DataBlock) -> Dict[str, ColumnStats]:
    return {name: column_stats(col) for name, col in block.items()}


def vector_stats(vectors: np.ndarray, metrics: List[str]) -> VectorStats:
    """Centroid + per-metric radius for one block's vector column.

    Port of the math (not the code) of
    vector_l1_l2_statistics_from_vectors / vector_dot_statistics_from_vectors
    (reference vector_index_writer.rs:571-607): l1/l2 radius is the max
    distance from centroid; for cosine the radius is the max angular
    distance of the normalized vectors from the normalized centroid.
    """
    v = np.asarray(vectors, np.float32)
    centroid = v.mean(axis=0)
    radius: Dict[str, float] = {}
    for m in metrics:
        if m == "l2":
            radius[m] = float(np.sqrt(((v - centroid) ** 2).sum(-1)).max())
        elif m == "l1":
            radius[m] = float(np.abs(v - centroid).sum(-1).max())
        elif m == "cosine":
            vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-30)
            cn = centroid / max(np.linalg.norm(centroid), 1e-30)
            cosd = 1.0 - vn @ cn
            radius[m] = float(cosd.max())
        elif m == "ip":
            # no triangle inequality: store max |x - centroid| norm, unused for pruning
            radius[m] = float(np.linalg.norm(v - centroid, axis=1).max())
    return VectorStats(centroid.astype(float).tolist(), radius, v.shape[0])


def score_domain(stats: VectorStats, query: np.ndarray, metric: str):
    """Per-block score interval [lo, hi] for a query
    (reference vector_index_pruner.rs:544-617 ``vector_stat_score_domain``).
    Returns None when the metric has no sound bound (ip)."""
    c = np.asarray(stats.centroid, np.float32)
    q = np.asarray(query, np.float32)
    r = stats.radius.get(metric)
    if r is None:
        return None
    if metric == "l2":
        d = float(np.sqrt(((q - c) ** 2).sum()))
    elif metric == "l1":
        d = float(np.abs(q - c).sum())
    elif metric == "cosine":
        qn = q / max(np.linalg.norm(q), 1e-30)
        cn = c / max(np.linalg.norm(c), 1e-30)
        d = float(1.0 - qn @ cn)
        # angular distances compose within [0, 2]
        return (max(d - r, 0.0), min(d + r, 2.0))
    else:
        return None
    return (max(d - r, 0.0), d + r)
