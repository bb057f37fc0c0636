"""Variant virtual columns: auto-extraction of scalar JSON leaf paths.

The reference's EE virtual_column feature scans every VARIANT column at
write time, extracts all scalar key paths (`v['a']['b']` -> one column
per distinct path), and persists them as a typed sidecar parquet next to
the block so queries touching `v['a']['b']` read ONE materialized column
instead of parsing JSON per row (reference:
src/query/storages/fuse/src/io/write/virtual_column_builder.rs:145,
src/query/sql/src/planner/binder/virtual_column.rs — binder rewrite,
src/query/storages/fuse/src/io/read/virtual_column/
virtual_column_reader_parquet.rs — block-aligned sidecar read).

This implementation stores each leaf as a VARIANT column (compact JSON
text, NULL where the path is absent), which makes the binder rewrite an
exact substitution for ``get(v, 'k')`` — no cast layer, identical
rendering. Typed min/max stats are still recorded per path for future
zone-map pruning. License-gated (EE "virtual_column") behind
``enable_experimental_virtual_column``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...expression import Column, DataBlock
from ...types import Variant

MAX_PATHS = 32      # most-frequent paths kept per block (reference caps too)
MAX_DEPTH = 5


def virtual_column_name(source: str, path: Tuple[str, ...]) -> str:
    return source + "".join(f"['{p}']" for p in path)


def _walk(prefix: Tuple[str, ...], obj, out: dict, row: int):
    if len(prefix) >= MAX_DEPTH:
        return
    for k, v in obj.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            _walk(p, v, out, row)
        elif isinstance(v, (str, int, float, bool)):
            out.setdefault(p, {})[row] = v
        # arrays and JSON nulls are not extracted (scalar leaves only)


def extract_virtual_columns(chunk: DataBlock):
    """-> (sidecar DataBlock | None, metas list).

    metas: [{"name", "source", "path", "type"}] — `type` is the inferred
    leaf type (for stats/pruning); the stored column is always VARIANT.
    """
    from ...types import VariantType
    n = chunk.num_rows
    cols_out: List[Column] = []
    metas: List[dict] = []
    names: List[str] = []
    for cname, col in chunk.items():
        if not isinstance(col.dtype.remove_nullable(), VariantType):
            continue
        paths: Dict[Tuple[str, ...], dict] = {}
        data = col.data
        validity = col.validity
        raw_list = (data.to_pylist() if hasattr(data, "to_pylist")
                    else list(data))
        for row in range(n):
            if validity is not None and not validity[row]:
                continue
            raw = raw_list[row]
            if raw is None:
                continue
            try:
                obj = raw if isinstance(raw, dict) else json.loads(raw)
            except (TypeError, ValueError):
                continue
            if isinstance(obj, dict):
                _walk((), obj, paths, row)
        if not paths:
            continue
        # keep the most frequent paths (reference cap behavior)
        ranked = sorted(paths.items(), key=lambda kv: -len(kv[1]))[:MAX_PATHS]
        for path, rowvals in sorted(ranked):
            vals = [None] * n
            pytypes = set()
            for row, v in rowvals.items():
                vals[row] = json.dumps(v, separators=(",", ":"),
                                       ensure_ascii=False)
                pytypes.add(bool if isinstance(v, bool) else type(v))
            if pytypes <= {bool}:
                leaf = "Boolean"
            elif pytypes <= {int}:
                leaf = "Int64"
            elif pytypes <= {int, float}:
                leaf = "Float64"
            elif pytypes <= {str}:
                leaf = "String"
            else:
                leaf = "Variant"
            name = virtual_column_name(cname, path)
            names.append(name)
            cols_out.append(Column.from_pylist(vals, Variant.wrap_nullable()))
            metas.append({"name": name, "source": cname,
                          "path": list(path), "type": leaf})
    if not cols_out:
        return None, []
    return DataBlock(names, cols_out, n), metas


def read_virtual_columns(table, meta, wanted: List[str],
                         n_rows: int) -> Dict[str, Column]:
    """Load the requested virtual columns for one block; paths absent in
    this block come back as all-NULL (block-aligned sidecar read)."""
    from ...expression.schema import DataField, TableSchema
    from . import block_io
    out: Dict[str, Column] = {}
    vc = meta.virtual_column or {}
    have = {c["name"] for c in vc.get("columns", [])}
    hit = [w for w in wanted if w in have]
    if hit:
        schema = TableSchema([DataField(c["name"], Variant.wrap_nullable())
                              for c in vc["columns"]])
        side = block_io.read_block(table.abs_path(vc["location"]), schema)
        for w in hit:
            out[w] = side.column(w)
    for w in wanted:
        if w not in out:
            # StringData payload like every variant column (concat-safe)
            out[w] = Column.from_pylist([None] * n_rows,
                                        Variant.wrap_nullable())
    return out
