from .column import Column, StringData
from .block import DataBlock
from .schema import DataField, TableSchema, VECTOR_SCORE_COL_NAME, SEARCH_SCORE_COL_NAME, SEARCH_MATCHED_COL_NAME, ROW_ID_COL_NAME

__all__ = [
    "Column",
    "StringData",
    "DataBlock",
    "DataField",
    "TableSchema",
    "VECTOR_SCORE_COL_NAME",
    "SEARCH_SCORE_COL_NAME",
    "SEARCH_MATCHED_COL_NAME",
    "ROW_ID_COL_NAME",
]
