from .catalog import Catalog, TableInfo, TableIndexDef, DatabaseInfo
from .pushdown import PushDownInfo, VectorIndexInfo, InvertedIndexInfo, Range

__all__ = [
    "Catalog",
    "TableInfo",
    "TableIndexDef",
    "DatabaseInfo",
    "PushDownInfo",
    "VectorIndexInfo",
    "InvertedIndexInfo",
    "Range",
]
