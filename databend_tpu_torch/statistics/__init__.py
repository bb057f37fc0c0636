from .table_stats import (ColumnStatistics, TableStatistics, analyze_table,
                          build_column_statistics,
                          histogram_range_fraction, load_table_stats)

__all__ = ["ColumnStatistics", "TableStatistics", "analyze_table",
           "build_column_statistics", "load_table_stats",
           "histogram_range_fraction"]
