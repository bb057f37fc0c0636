"""Logical/physical plan nodes.

Single-tier plan (the reference's SExpr -> PhysicalPlan split collapses:
host orchestration is cheap here, the heavy lifting is inside jitted scans).
Reference analogs: src/query/sql/src/planner/plans/ and
src/query/service/src/physical_plans/.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..catalog.pushdown import PushDownInfo
from ..expression import DataBlock, DataField
from ..expression.expr import ScalarExpr
from ..expression.functions.aggregates import AggregateFunction
from ..types import DataType


class Plan:
    def children(self) -> List["Plan"]:
        return []

    def output_fields(self) -> List[DataField]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    def explain(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = pad + self._explain_line()
        return "\n".join([line] + [c.explain(indent + 1) for c in self.children()])

    def _explain_line(self) -> str:
        return self.name()


@dataclass
class Scan(Plan):
    table: object  # FuseTable
    pushdown: PushDownInfo
    # internal columns to materialize (_vector_score, _search_matched, ...)
    internal_columns: List[str] = field(default_factory=list)
    snapshot_id: Optional[str] = None
    # columns actually needed downstream (base schema names)
    columns: Optional[List[str]] = None
    # variant virtual columns to surface (EE; read from the block's
    # sidecar parquet — reference virtual_column_reader_parquet.rs)
    virtual_columns: List[str] = field(default_factory=list)

    def output_fields(self):
        from ..expression.schema import (SEARCH_MATCHED_COL_NAME,
                                         SEARCH_SCORE_COL_NAME,
                                         VECTOR_SCORE_COL_NAME)
        from ..types import Boolean, Float32
        names = self.columns if self.columns is not None \
            else self.table.schema.field_names()
        fields = [self.table.schema.field(n) for n in names]
        for ic in self.internal_columns:
            if ic == VECTOR_SCORE_COL_NAME:
                fields.append(DataField(ic, Float32))
            elif ic == SEARCH_SCORE_COL_NAME:
                fields.append(DataField(ic, Float32))
            elif ic == SEARCH_MATCHED_COL_NAME:
                fields.append(DataField(ic, Boolean))
        if self.virtual_columns:
            from ..types import Variant
            fields += [DataField(vc, Variant.wrap_nullable())
                       for vc in self.virtual_columns]
        return fields

    def _explain_line(self):
        pd = self.pushdown
        bits = [f"Scan: {self.table.info.database}.{self.table.info.name}"]
        if self.virtual_columns:
            bits.append(f"virtual_columns=[{', '.join(self.virtual_columns)}]")
        if pd.filters is not None:
            bits.append(f"filter=[{pd.filters.display()}]")
        if pd.limit is not None:
            bits.append(f"limit={pd.limit}")
        if pd.vector_index is not None:
            bits.append(f"vector_index={pd.vector_index.index_name}"
                        f"({pd.vector_index.func_name},"
                        f" hnsw={'on' if pd.vector_index.topk_asc else 'brute'})")
        if pd.inverted_index is not None:
            bits.append(f"inverted_index={pd.inverted_index.index_name}")
        return " ".join(bits)


@dataclass
class ValuesPlan(Plan):
    block: DataBlock
    fields: List[DataField]

    def output_fields(self):
        return self.fields


@dataclass
class FilterPlan(Plan):
    child: Plan
    expr: ScalarExpr

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.child.output_fields()

    def _explain_line(self):
        return f"Filter: {self.expr.display()}"


@dataclass
class ProjectPlan(Plan):
    child: Plan
    items: List[Tuple[str, ScalarExpr]]  # output name -> expr over child

    def children(self):
        return [self.child]

    def output_fields(self):
        return [DataField(n, e.dtype) for n, e in self.items]

    def _explain_line(self):
        return "Project: " + ", ".join(n for n, _ in self.items)


@dataclass
class AggregatePlan(Plan):
    child: Plan
    keys: List[Tuple[str, ScalarExpr]]  # group-by keys (name, expr)
    # (output name, agg function instance, arg exprs)
    aggs: List[Tuple[str, AggregateFunction, List[ScalarExpr]]]
    # run the merge through the mesh exchange (psum of grouped partials)
    distributed: bool = False
    # buffered input rows above which the aggregation switches to
    # hash-partitioned spill (reference spillers/inner.rs:269); None = never
    spill_threshold_rows: Optional[int] = None
    # answer eligible aggregates from block statistics / the aggregating
    # index (setting enable_aggregating_index_scan)
    stats_fast_path: bool = True
    # set by the optimizer when a matching AGGREGATING INDEX answers this
    # aggregate from per-block partials alone (index-only scan)
    agg_index: Optional[str] = None

    def children(self):
        return [self.child]

    def output_fields(self):
        out = [DataField(n, e.dtype) for n, e in self.keys]
        out += [DataField(n, f.return_type().wrap_nullable()
                          if not f.name.startswith("count") else f.return_type())
                for n, f, _ in self.aggs]
        return out

    def _explain_line(self):
        line = (f"Aggregate: keys=[{', '.join(n for n, _ in self.keys)}] "
                f"aggs=[{', '.join(n for n, _, _ in self.aggs)}]")
        if self.agg_index:
            line += f" from_index={self.agg_index} (index-only scan)"
        if getattr(self, "_device_routed", False):
            line += " device=scan_agg (one XLA program, resident columns)"
        return line


@dataclass
class SortItem:
    name: str
    asc: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class SortPlan(Plan):
    child: Plan
    items: List[SortItem]
    limit: Optional[int] = None  # top-n fast path
    # rows above which the sort spills sorted runs to disk and k-way
    # merges them (reference sort_spill.rs); None = never spill
    spill_threshold_rows: Optional[int] = None
    # top-n through the mesh's ordered merge exchange when eligible
    distributed: bool = False

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.child.output_fields()

    def _explain_line(self):
        keys = ", ".join(f"{i.name} {'ASC' if i.asc else 'DESC'}" for i in self.items)
        return f"Sort: [{keys}]" + (f" limit={self.limit}" if self.limit else "")


@dataclass
class LimitPlan(Plan):
    child: Plan
    limit: Optional[int]
    offset: int = 0

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.child.output_fields()

    def _explain_line(self):
        return f"Limit: {self.limit} offset={self.offset}"


@dataclass
class JoinPlan(Plan):
    kind: str  # INNER | LEFT | RIGHT | FULL | CROSS
    # broadcast-exchange probe on the mesh when eligible

    left: Plan
    right: Plan
    left_keys: List[ScalarExpr]
    right_keys: List[ScalarExpr]
    residual: Optional[ScalarExpr] = None  # non-equi condition over joined row
    fields: List[DataField] = field(default_factory=list)
    distributed: bool = False
    # build-side rows above which the join grace-partitions both sides to
    # disk and joins partition-by-partition; None = never spill
    spill_threshold_rows: Optional[int] = None
    # push build-side key min/max into the probe scan's pushdown so the
    # range pruner skips probe blocks (reference join runtime filters)
    runtime_filter: bool = True
    # SEMI/ANTI joins output left columns only; the full joined field list
    # is kept here for residual evaluation
    all_fields: Optional[List[DataField]] = None

    def children(self):
        return [self.left, self.right]

    def output_fields(self):
        return self.fields

    def _explain_line(self):
        return f"{self.kind}Join: keys={len(self.left_keys)}"


@dataclass
class WindowItem:
    out_name: str
    func: str                       # row_number | rank | ... | sum | avg | ...
    args: List[ScalarExpr]
    partition_by: List[ScalarExpr]
    order_by: List[Tuple[ScalarExpr, bool, Optional[bool]]]  # (expr, asc, nulls_first)
    dtype: DataType = None
    # frame (start, end): None bound = unbounded; offset is a row count
    # for ROWS frames, an ORDER BY key delta for RANGE frames
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    frame_kind: str = "rows"  # rows | range


@dataclass
class WindowPlan(Plan):
    """Window-function evaluation (reference: window transforms under
    src/query/service/src/pipelines/processors/transforms/window/ and the
    WindowFunction plan, src/query/sql/src/planner/plans/). Executed as
    one vectorized pass: lexsort by (partition, order) keys, segmented
    scans on the sorted arrays, inverse-permute back."""
    child: Plan
    items: List[WindowItem]
    # partition-hash exchange across the mesh when eligible
    distributed: bool = False

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.child.output_fields() + [
            DataField(i.out_name, i.dtype) for i in self.items]

    def _explain_line(self):
        return "Window: " + ", ".join(f"{i.func}() as {i.out_name}" for i in self.items)


@dataclass
class UnionAllPlan(Plan):
    inputs: List[Plan]

    def children(self):
        return self.inputs

    def output_fields(self):
        return self.inputs[0].output_fields()


@dataclass
class SetOpPlan(Plan):
    """INTERSECT / EXCEPT with DISTINCT semantics (reference set ops)."""

    op: str  # "INTERSECT" | "EXCEPT"
    left: Plan
    right: Plan

    def children(self):
        return [self.left, self.right]

    def output_fields(self):
        return self.left.output_fields()

    def _explain_line(self):
        return self.op


@dataclass
class DistinctPlan(Plan):
    child: Plan

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.child.output_fields()


@dataclass
class LateralFlattenPlan(Plan):
    """LATERAL FLATTEN(input => <expr over child>) — per-row explode of a
    variant/array expression (reference: the FLATTEN srf table function
    joined laterally)."""

    child: Plan
    input_expr: ScalarExpr
    params: dict  # path/outer/mode/recursive
    fields: List[DataField]  # child fields + flatten output fields
    unnest: bool = False  # typed-element value column (unnest) vs variant

    def children(self):
        return [self.child]

    def output_fields(self):
        return self.fields

    def _explain_line(self):
        return f"LateralFlatten({self.input_expr.display()})"
