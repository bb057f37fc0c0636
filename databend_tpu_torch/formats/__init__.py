"""File format decoders/encoders for COPY and streaming load.

Reference analog: src/query/formats (CSV/TSV/NDJSON/Parquet/Avro field
decoders, 6,047 LoC). Here each format maps a file to/from a DataBlock;
type coercion reuses the expression layer's cast kernels so COPY follows
the same conversion rules as INSERT.
"""

from .registry import (detect_format, infer_schema, read_file, write_file,
                       FileFormatOptions)

__all__ = ["detect_format", "infer_schema", "read_file", "write_file",
           "FileFormatOptions"]
