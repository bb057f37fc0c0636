"""Schemas and internal column names.

Mirrors the reference's schema layer (src/query/expression/src/schema.rs):
internal score/search columns use the same reserved names so the SQL surface
matches (``_vector_score``: schema.rs:76; ``_search_score``/``_search_matched``:
src/query/catalog/src/plan/internal_column.rs:152-221).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..errors import UnknownColumn
from ..types import DataType, parse_type_name

VECTOR_SCORE_COL_NAME = "_vector_score"
SEARCH_SCORE_COL_NAME = "_search_score"
SEARCH_MATCHED_COL_NAME = "_search_matched"
ROW_ID_COL_NAME = "_row_id"
BLOCK_NAME_COL_NAME = "_block_name"

INTERNAL_COLUMN_NAMES = {
    VECTOR_SCORE_COL_NAME,
    SEARCH_SCORE_COL_NAME,
    SEARCH_MATCHED_COL_NAME,
    ROW_ID_COL_NAME,
    BLOCK_NAME_COL_NAME,
}


@dataclass
class DataField:
    name: str
    dtype: DataType
    default: Optional[object] = None
    column_id: int = 0
    # RENAME COLUMN history: old on-disk names, oldest first. Blocks written
    # before a rename are resolved through these at read time (the
    # name-based analog of the reference's column-id resolution).
    prior_names: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "type": self.dtype.sql_name(),
            "default": self.default,
            "column_id": self.column_id,
        }
        if self.prior_names:
            d["prior_names"] = list(self.prior_names)
        return d

    @staticmethod
    def from_dict(d: dict) -> "DataField":
        return DataField(d["name"], parse_type_name(d["type"]), d.get("default"),
                         d.get("column_id", 0), list(d.get("prior_names") or []))


@dataclass
class TableSchema:
    fields: List[DataField] = field(default_factory=list)
    next_column_id: int = 0

    def __post_init__(self):
        if self.next_column_id == 0 and self.fields:
            for i, f in enumerate(self.fields):
                if f.column_id == 0:
                    f.column_id = i
            self.next_column_id = max(f.column_id for f in self.fields) + 1

    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name.lower() == name.lower():
                return i
        raise UnknownColumn(f"unknown column {name!r}")

    def field(self, name: str) -> DataField:
        return self.fields[self.index_of(name)]

    def has_field(self, name: str) -> bool:
        return any(f.name.lower() == name.lower() for f in self.fields)

    def column_id_of(self, name: str) -> int:
        return self.field(name).column_id

    def project(self, names: List[str]) -> "TableSchema":
        return TableSchema([self.fields[self.index_of(n)] for n in names],
                           next_column_id=self.next_column_id)

    def to_dict(self) -> dict:
        return {"fields": [f.to_dict() for f in self.fields],
                "next_column_id": self.next_column_id}

    @staticmethod
    def from_dict(d: dict) -> "TableSchema":
        return TableSchema([DataField.from_dict(f) for f in d["fields"]],
                           d.get("next_column_id", 0))
