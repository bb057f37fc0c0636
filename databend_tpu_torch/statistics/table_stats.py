"""Table-level optimizer statistics: NDV + equi-height histograms.

Populated by ``ANALYZE TABLE t`` and consumed by the cost-based optimizer's
cardinality estimator. Reference: src/common/statistics (equi-height
histogram + NDV estimation used by the cascades cost model) and the
ANALYZE TABLE interpreter
(src/query/service/src/interpreters/interpreter_table_analyze.rs).

Stored in the meta service under ``table_stats/{table_id}`` together with
the snapshot id they were computed against, so the estimator can tell when
they are stale (stale stats are still used — scaled by the current/analyzed
row-count ratio — matching the reference's behavior of using the latest
histogram until the next ANALYZE).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HISTOGRAM_BUCKETS = 32


@dataclass
class ColumnStatistics:
    """Per-column optimizer stats (reference: Histogram + NDV)."""
    ndv: float
    null_count: int
    min: Optional[float] = None      # numeric-comparable domain only
    max: Optional[float] = None
    # equi-height histogram: ascending bucket upper bounds + row count and
    # distinct count per bucket. bounds[i] is the max value in bucket i.
    bounds: List[float] = field(default_factory=list)
    counts: List[int] = field(default_factory=list)
    ndvs: List[float] = field(default_factory=list)

    def to_dict(self):
        return {"ndv": self.ndv, "null_count": self.null_count,
                "min": self.min, "max": self.max, "bounds": self.bounds,
                "counts": self.counts, "ndvs": self.ndvs}

    @staticmethod
    def from_dict(d):
        return ColumnStatistics(d["ndv"], d["null_count"], d.get("min"),
                                d.get("max"), d.get("bounds", []),
                                d.get("counts", []), d.get("ndvs", []))


@dataclass
class TableStatistics:
    row_count: int
    snapshot_id: Optional[str]
    columns: Dict[str, ColumnStatistics]

    def to_dict(self):
        return {"row_count": self.row_count, "snapshot_id": self.snapshot_id,
                "columns": {n: c.to_dict() for n, c in self.columns.items()}}

    @staticmethod
    def from_dict(d):
        return TableStatistics(
            d["row_count"], d.get("snapshot_id"),
            {n: ColumnStatistics.from_dict(c)
             for n, c in d.get("columns", {}).items()})


def _numeric_view(col) -> Optional[np.ndarray]:
    """A 1-D float view of the column's valid values for histogramming, or
    None when the type has no meaningful numeric order (vectors, variants)."""
    data = col.data
    if not isinstance(data, np.ndarray) or data.ndim != 1:
        return None
    if data.dtype.kind not in "iufb":
        return None
    vals = data if col.validity is None else data[col.validity]
    return vals.astype(np.float64, copy=False)


def build_column_statistics(col) -> ColumnStatistics:
    """Exact NDV + equi-height histogram over one in-memory column."""
    n = len(col)
    nulls = 0 if col.validity is None else int(n - col.validity.sum())
    vals = _numeric_view(col)
    if vals is None or len(vals) == 0:
        # string/complex columns: NDV only (hash the python values)
        try:
            pyvals = [v for v in col.to_pylist() if v is not None]
            ndv = float(len(set(map(str, pyvals))))
        except Exception:
            ndv = float(max(n - nulls, 1))
        return ColumnStatistics(ndv=ndv, null_count=nulls)

    sorted_vals = np.sort(vals)
    uniq = np.unique(sorted_vals)
    ndv = float(len(uniq))
    nb = min(HISTOGRAM_BUCKETS, len(uniq))
    bounds, counts, ndvs = [], [], []
    if nb > 0:
        # equi-height: split the sorted values into nb equal-row slices,
        # extending each slice to the last duplicate of its boundary value
        # so a value never spans two buckets
        edges = np.linspace(0, len(sorted_vals), nb + 1).astype(np.int64)[1:]
        start = 0
        for e in edges:
            e = int(e)
            if e <= start:
                continue
            ub = sorted_vals[e - 1]
            # extend to include all duplicates of ub
            e = int(np.searchsorted(sorted_vals, ub, side="right"))
            sl = sorted_vals[start:e]
            if len(sl) == 0:
                continue
            bounds.append(float(ub))
            counts.append(int(len(sl)))
            ndvs.append(float(len(np.unique(sl))))
            start = e
        if start < len(sorted_vals):  # remainder after dedup extension
            sl = sorted_vals[start:]
            bounds.append(float(sl[-1]))
            counts.append(int(len(sl)))
            ndvs.append(float(len(np.unique(sl))))
    return ColumnStatistics(ndv=ndv, null_count=nulls,
                            min=float(sorted_vals[0]),
                            max=float(sorted_vals[-1]),
                            bounds=bounds, counts=counts, ndvs=ndvs)


def histogram_range_fraction(cs: ColumnStatistics, lo: Optional[float],
                             hi: Optional[float], lo_inc: bool = True,
                             hi_inc: bool = True) -> Optional[float]:
    """Fraction of (non-null) rows with lo <= v <= hi, from the histogram.

    None when no histogram is available. Within a bucket, assumes a uniform
    value distribution (the standard equi-height interpolation).
    """
    if not cs.bounds or cs.min is None:
        return None
    total = float(sum(cs.counts))
    if total == 0:
        return None
    lo_v = cs.min if lo is None else lo
    hi_v = cs.max if hi is None else hi
    if hi_v < cs.min or lo_v > cs.max or hi_v < lo_v:
        return 0.0
    got = 0.0
    prev_ub = cs.min
    for i, ub in enumerate(cs.bounds):
        b_lo = prev_ub if i == 0 else cs.bounds[i - 1]
        width = max(ub - b_lo, 0.0)
        cnt = cs.counts[i]
        # overlap of [lo_v, hi_v] with (b_lo, ub]
        seg_lo = max(lo_v, b_lo)
        seg_hi = min(hi_v, ub)
        if seg_hi >= seg_lo:
            if width <= 0:
                got += cnt  # single-valued bucket fully inside
            else:
                got += cnt * (seg_hi - seg_lo) / width
        prev_ub = ub
    return min(max(got / total, 0.0), 1.0)


# --------------------------------------------------------------- persistence

def _stats_key(table_id: int) -> str:
    return f"table_stats/{table_id}"


def analyze_table(session, table) -> TableStatistics:
    """Full-scan ANALYZE: exact NDV + histograms for every column."""
    from ..catalog.pushdown import PushDownInfo
    from ..expression import DataBlock

    snap = table.read_snapshot()
    parts, _ = table.read_partitions(PushDownInfo())
    blocks = [table.read_block(p.meta) for p in parts]
    merged = DataBlock.concat(blocks) if blocks else None
    cols: Dict[str, ColumnStatistics] = {}
    rows = 0
    if merged is not None:
        rows = merged.num_rows
        for name, col in merged.items():
            cols[name] = build_column_statistics(col)
    stats = TableStatistics(row_count=rows,
                            snapshot_id=snap.snapshot_id if snap else None,
                            columns=cols)
    session.meta.upsert(_stats_key(table.info.table_id), stats.to_dict())
    return stats


def load_table_stats(session, table_id: int) -> Optional[TableStatistics]:
    v, _ = session.meta.get(_stats_key(table_id))
    return TableStatistics.from_dict(v) if v is not None else None
