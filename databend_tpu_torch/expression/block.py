"""DataBlock: the unit of data flowing through pipelines.

Analog of the reference's ``DataBlock`` (src/query/expression/src/block.rs):
an ordered set of equal-length named columns. Host-resident (numpy); scans
move the hot columns to device as ``[N, dim]``/1-D jnp arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .column import Column


class DataBlock:
    __slots__ = ("_names", "_columns", "_index", "num_rows", "meta")

    def __init__(self, names: Sequence[str], columns: Sequence[Column],
                 num_rows: Optional[int] = None, meta: Optional[dict] = None):
        assert len(names) == len(columns)
        self._names = list(names)
        self._columns = list(columns)
        self._index = {n.lower(): i for i, n in enumerate(self._names)}
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        for c in self._columns:
            assert len(c) == num_rows, f"column length {len(c)} != {num_rows}"
        self.num_rows = num_rows
        self.meta = meta or {}

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_dict(d: Dict[str, Column]) -> "DataBlock":
        return DataBlock(list(d.keys()), list(d.values()))

    @staticmethod
    def empty() -> "DataBlock":
        return DataBlock([], [], num_rows=0)

    # ------------------------------------------------------------------ access
    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def columns(self) -> List[Column]:
        return list(self._columns)

    def __len__(self) -> int:
        return self.num_rows

    def num_columns(self) -> int:
        return len(self._columns)

    def has_column(self, name: str) -> bool:
        return name.lower() in self._index

    def column(self, name: str) -> Column:
        return self._columns[self._index[name.lower()]]

    def column_at(self, i: int) -> Column:
        return self._columns[i]

    def items(self) -> Iterable[Tuple[str, Column]]:
        return zip(self._names, self._columns)

    # ------------------------------------------------------------------ edit
    def with_column(self, name: str, col: Column) -> "DataBlock":
        names, cols = list(self._names), list(self._columns)
        key = name.lower()
        if key in self._index:
            cols[self._index[key]] = col
        else:
            names.append(name)
            cols.append(col)
        return DataBlock(names, cols, self.num_rows if cols else None, dict(self.meta))

    def project(self, names: Sequence[str]) -> "DataBlock":
        cols = [self.column(n) for n in names]
        return DataBlock(list(names), cols, self.num_rows, dict(self.meta))

    def rename(self, mapping: Dict[str, str]) -> "DataBlock":
        names = [mapping.get(n, n) for n in self._names]
        return DataBlock(names, self._columns, self.num_rows, dict(self.meta))

    # ------------------------------------------------------------------ kernels
    def take(self, indices) -> "DataBlock":
        indices = np.asarray(indices, dtype=np.int64)
        return DataBlock(self._names, [c.take(indices) for c in self._columns],
                         len(indices), dict(self.meta))

    def slice(self, start: int, end: int) -> "DataBlock":
        end = min(end, self.num_rows)
        return DataBlock(self._names, [c.slice(start, end) for c in self._columns],
                         end - start, dict(self.meta))

    def filter(self, mask: np.ndarray) -> "DataBlock":
        mask = np.asarray(mask, dtype=np.bool_)
        return self.take(np.nonzero(mask)[0])

    @staticmethod
    def concat(blocks: Sequence["DataBlock"]) -> "DataBlock":
        blocks = [b for b in blocks if b.num_columns() > 0 or b.num_rows > 0]
        if not blocks:
            return DataBlock.empty()
        names = blocks[0]._names
        cols = [Column.concat([b._columns[i] for b in blocks]) for i in range(len(names))]
        return DataBlock(names, cols)

    # ------------------------------------------------------------------ export
    def to_pydict(self) -> Dict[str, list]:
        return {n: c.to_pylist() for n, c in self.items()}

    def to_rows(self) -> List[tuple]:
        lists = [c.to_pylist() for c in self._columns]
        return list(zip(*lists)) if lists else []

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataBlock(rows={self.num_rows}, cols={self._names})"
