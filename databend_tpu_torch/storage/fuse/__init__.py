from .table import FuseTable
from .snapshot import BlockMeta, SegmentInfo, TableSnapshot, ColumnStats

__all__ = ["FuseTable", "BlockMeta", "SegmentInfo", "TableSnapshot", "ColumnStats"]
