"""Format registry: CSV / TSV / NDJSON / PARQUET read+write.

Reference analogs: src/query/formats/src/field_decoder/ (per-format field
decoders) and output formats. Values are decoded as python objects then
lowered through Column.from_pylist + cast so NULL/typing semantics match
the INSERT path exactly.
"""

from __future__ import annotations

import csv
import io
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..errors import BadArguments, SemanticError
from ..expression import Column, DataBlock, StringData
from ..expression.schema import TableSchema
from ..types import (ArrayType, Boolean, Date, NumberType, String, StringType,
                     Timestamp, VectorType)


@dataclass
class FileFormatOptions:
    type: str = "CSV"                  # CSV | TSV | NDJSON | PARQUET
    field_delimiter: str = ","
    record_delimiter: str = "\n"
    skip_header: int = 0
    quote: str = '"'
    compression: str = "NONE"  # NONE | GZIP | ZSTD | BZ2 | XZ | AUTO
    # (reference src/common/compress: zstd/lz4/brotli/xz — zstd/bz2/xz map
    # to the codecs available here; lz4/brotli/snappy raise a clear error)
    null_display: str = "\\N"

    @staticmethod
    def from_dict(d: Dict[str, str]) -> "FileFormatOptions":
        o = FileFormatOptions()
        for k, v in d.items():
            k = k.lower()
            if k == "type":
                o.type = str(v).upper()
            elif k == "field_delimiter":
                o.field_delimiter = str(v)
            elif k == "record_delimiter":
                o.record_delimiter = str(v)
            elif k == "skip_header":
                o.skip_header = int(v)
            elif k == "quote":
                o.quote = str(v)
            elif k == "compression":
                o.compression = str(v).upper()
            elif k == "null_display":
                o.null_display = str(v)
            else:
                raise BadArguments(f"unknown file format option {k!r}")
        if o.type == "TSV":
            o.type = "CSV"
            o.field_delimiter = "\t"
        return o


def detect_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    return {"csv": "CSV", "tsv": "TSV", "ndjson": "NDJSON", "jsonl": "NDJSON",
            "json": "NDJSON", "parquet": "PARQUET", "pq": "PARQUET",
            "orc": "ORC", "avro": "AVRO"}.get(ext, "CSV")


_COMPRESSION_EXT = {".gz": "GZIP", ".gzip": "GZIP", ".zst": "ZSTD",
                    ".zstd": "ZSTD", ".bz2": "BZ2", ".xz": "XZ",
                    ".lz4": "LZ4"}


def _compression_of(path: str, opts: FileFormatOptions) -> str:
    c = opts.compression.upper()
    if c in ("NONE", "AUTO"):
        ext = os.path.splitext(path)[1].lower()
        detected = _COMPRESSION_EXT.get(ext, "NONE")
        return detected
    if c in ("BROTLI", "SNAPPY", "DEFLATE", "RAW_DEFLATE"):
        raise BadArguments(
            f"compression {c} is not available in this build; use"
            " GZIP/ZSTD/BZ2/XZ/LZ4")
    return c


def _open_text(path: str, opts: FileFormatOptions, mode: str = "rt"):
    enc = None if "b" in mode else "utf-8"
    c = _compression_of(path, opts)
    if c == "GZIP":
        import gzip
        return gzip.open(path, mode, encoding=enc)
    if c == "ZSTD":
        import zstandard
        return zstandard.open(path, mode, encoding=enc)
    if c == "BZ2":
        import bz2
        return bz2.open(path, mode, encoding=enc)
    if c == "XZ":
        import lzma
        return lzma.open(path, mode, encoding=enc)
    if c == "LZ4":
        import io
        from . import lz4
        if "r" in mode:
            with open(path, "rb") as f:
                raw = lz4.decompress(f.read())
            return io.BytesIO(raw) if "b" in mode else \
                io.StringIO(raw.decode("utf-8"))

        class _LZ4Writer(io.BytesIO):
            def close(self_inner):
                data = self_inner.getvalue()
                with open(path, "wb") as f:
                    f.write(lz4.compress(data))
                super().close()
        w = _LZ4Writer()
        return w if "b" in mode else io.TextIOWrapper(w, encoding="utf-8")
    if c != "NONE":
        raise BadArguments(f"unknown compression {c!r}")
    return open(path, mode, encoding=enc)


def _parse_cell(text: Optional[str], dtype, opts: FileFormatOptions):
    if text is None or text == opts.null_display or text == "":
        inner = dtype.remove_nullable()
        if isinstance(inner, StringType) and text == "":
            return ""
        return None
    inner = dtype.remove_nullable()
    if isinstance(inner, StringType):
        return text
    if inner is Boolean:
        return text.strip().lower() in ("1", "true", "t", "yes")
    if isinstance(inner, (VectorType, ArrayType)):
        return json.loads(text)
    if isinstance(inner, NumberType):
        return int(text) if inner.is_integer() else float(text)
    return text  # dates/timestamps: cast layer parses strings


def _rows_to_block(rows: List[List], schema: TableSchema,
                   opts: FileFormatOptions) -> DataBlock:
    from ..expression.evaluator import cast_column
    nfields = len(schema.fields)
    cols = []
    names = []
    for i, f in enumerate(schema.fields):
        vals = [(_parse_cell(r[i] if i < len(r) else None, f.dtype, opts)
                 if not isinstance(r[i] if i < len(r) else None, (list, int, float, bool, dict))
                 else (r[i] if i < len(r) else None))
                for r in rows]
        col = Column.from_pylist(vals, f.dtype.wrap_nullable()
                                 if any(v is None for v in vals) else f.dtype)
        if col.dtype.remove_nullable() != f.dtype.remove_nullable():
            col = cast_column(col, f.dtype, False)
        cols.append(col)
        names.append(f.name)
    return DataBlock(names, cols, len(rows))


# ------------------------------------------------------------------- readers
def _csv_rows_native(path: str, opts: FileFormatOptions):
    """Tokenize with the C++ scanner (native/csv_scan.cpp); None = fall back."""
    from .. import native
    if (_compression_of(path, opts) != "NONE"
            or len(opts.field_delimiter) != 1 or len(opts.quote) != 1):
        return None
    if not native.available():
        return None
    with open(path, "rb") as f:
        data = f.read()
    scanned = native.csv_scan(data, opts.field_delimiter, opts.quote)
    if scanned is None:
        return None
    starts, lens, quoted, row_ends = scanned
    q = opts.quote
    rows = []
    begin = 0
    for end in row_ends:
        row = []
        for i in range(begin, end):
            cell = data[starts[i]:starts[i] + lens[i]].decode("utf-8")
            if quoted[i]:
                cell = cell.strip()
                if len(cell) >= 2 and cell[0] == q and cell[-1] == q:
                    cell = cell[1:-1]
                cell = cell.replace(q + q, q)
            row.append(cell)
        rows.append(row)
        begin = end
    return rows


def _read_csv(path: str, schema: TableSchema, opts: FileFormatOptions) -> DataBlock:
    rows = _csv_rows_native(path, opts)
    if rows is None:
        with _open_text(path, opts) as f:
            reader = csv.reader(f, delimiter=opts.field_delimiter,
                                quotechar=opts.quote)
            rows = list(reader)
    rows = rows[opts.skip_header:]
    return _rows_to_block(rows, schema, opts)


def _read_ndjson(path: str, schema: TableSchema, opts: FileFormatOptions) -> DataBlock:
    objs = []
    with _open_text(path, opts) as f:
        for line in f:
            line = line.strip()
            if line:
                objs.append(json.loads(line))
    lower = {f.name.lower(): f.name for f in schema.fields}
    rows = []
    for o in objs:
        o2 = {k.lower(): v for k, v in o.items()}
        rows.append([o2.get(f.name.lower()) for f in schema.fields])
    return _rows_to_block(rows, schema, opts)


def _read_parquet(path: str, schema: TableSchema, opts: FileFormatOptions) -> DataBlock:
    from ..storage.fuse.block_io import read_block
    return read_block(path, schema)


def _read_orc(path: str, schema: TableSchema, opts: FileFormatOptions) -> DataBlock:
    """ORC via pyarrow (reference: src/query/storages/orc + formats)."""
    import pyarrow.orc as paorc

    from ..storage.fuse.block_io import _from_arrow_array
    table = paorc.ORCFile(path).read()
    lower = {c.lower(): c for c in table.column_names}
    cols, names = [], []
    for f in schema.fields:
        names.append(f.name)
        src = lower.get(f.name.lower())
        if src is None:
            from ..expression.evaluator import constant_column
            cols.append(constant_column(None, f.dtype.wrap_nullable(),
                                        table.num_rows))
        else:
            cols.append(_from_arrow_array(table.column(src), f.dtype))
    return DataBlock(names, cols, table.num_rows)


def _read_avro(path: str, schema: TableSchema, opts: FileFormatOptions) -> DataBlock:
    """Avro OCF via the built-in decoder (no avro lib in this image;
    reference: src/query/formats avro support)."""
    from .avro import read_avro_records
    records = read_avro_records(path)
    rows = []
    for o in records:
        o2 = {k.lower(): v for k, v in o.items()}
        rows.append([o2.get(f.name.lower()) for f in schema.fields])
    return _rows_to_block(rows, schema, opts)


def _infer_value_type(vals):
    """Pick the narrowest of Int64/Float64/Boolean/String/Variant covering
    the sampled python values (None-tolerant)."""
    from ..types import Float64, Int64, Variant
    got = {type(v) for v in vals if v is not None}
    if not got:
        return String.wrap_nullable()
    if got <= {bool}:
        t = Boolean
    elif got <= {int, bool}:
        t = Int64
    elif got <= {int, float, bool}:
        t = Float64
    elif got <= {str}:
        t = String
    else:
        t = Variant
    return t.wrap_nullable() if any(v is None for v in vals) else t


def infer_schema(path: str, opts: Optional[FileFormatOptions] = None,
                 sample_rows: int = 256) -> TableSchema:
    """Schema inference for schemaless reads (SELECT FROM @stage).

    Reference behavior (src/query/storages/stage): parquet exposes its own
    schema; NDJSON/Avro infer names+types from records; CSV/TSV expose
    positional ``$1..$n`` string columns.
    """
    from ..expression.schema import DataField
    if opts is None:
        opts = FileFormatOptions(type=detect_format(path))
    t = opts.type.upper()
    if t in ("CSV", "TSV"):
        rows = _csv_rows_native(path, opts)
        if rows is None:
            with _open_text(path, opts) as f:
                reader = csv.reader(f, delimiter=opts.field_delimiter,
                                    quotechar=opts.quote)
                rows = []
                for r in reader:
                    rows.append(r)
                    if len(rows) >= sample_rows:
                        break
        width = max((len(r) for r in rows[opts.skip_header:]), default=0)
        return TableSchema([DataField(f"${i+1}", String.wrap_nullable())
                            for i in range(width)])
    if t in ("NDJSON", "AVRO"):
        if t == "NDJSON":
            objs = []
            with _open_text(path, opts) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        objs.append(json.loads(line))
                    if len(objs) >= sample_rows:
                        break
        else:
            from .avro import read_avro_records
            objs = read_avro_records(path)[:sample_rows]
        names: List[str] = []
        for o in objs:
            for k in o:
                if k not in names:
                    names.append(k)
        return TableSchema([
            DataField(n, _infer_value_type([o.get(n) for o in objs]))
            for n in names])
    if t in ("PARQUET", "ORC"):
        from ..storage.fuse.block_io import arrow_schema_to_fields
        if t == "PARQUET":
            import pyarrow.parquet as pq
            arrow = pq.read_schema(path)
        else:
            import pyarrow.orc as paorc
            arrow = paorc.ORCFile(path).schema
        return TableSchema(arrow_schema_to_fields(arrow))
    raise BadArguments(f"cannot infer schema for format {t!r}")


def read_file(path: str, schema: TableSchema,
              opts: Optional[FileFormatOptions] = None) -> DataBlock:
    if opts is None:
        opts = FileFormatOptions(type=detect_format(path))
    t = opts.type.upper()
    if t in ("CSV", "TSV"):
        return _read_csv(path, schema, opts)
    if t == "NDJSON":
        return _read_ndjson(path, schema, opts)
    if t == "PARQUET":
        return _read_parquet(path, schema, opts)
    if t == "ORC":
        return _read_orc(path, schema, opts)
    if t == "AVRO":
        return _read_avro(path, schema, opts)
    raise BadArguments(f"unsupported file format {t!r}")


# ------------------------------------------------------------------- writers
def _cell_text(v, opts: FileFormatOptions) -> str:
    if v is None:
        return opts.null_display
    if isinstance(v, (list, tuple)):
        return json.dumps(list(v))
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_file(path: str, block: DataBlock,
               opts: Optional[FileFormatOptions] = None) -> int:
    if opts is None:
        opts = FileFormatOptions(type=detect_format(path))
    t = opts.type.upper()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if t in ("CSV", "TSV"):
        with _open_text(path, opts, "wt") as f:
            w = csv.writer(f, delimiter=opts.field_delimiter,
                           quotechar=opts.quote, lineterminator=opts.record_delimiter)
            for r in block.to_rows():
                w.writerow([_cell_text(v, opts) if v is not None else opts.null_display
                            for v in r])
        return block.num_rows
    if t == "NDJSON":
        names = [n for n, _ in block.items()]
        with _open_text(path, opts, "wt") as f:
            for r in block.to_rows():
                f.write(json.dumps({n: (list(v) if isinstance(v, (list, tuple)) else v)
                                    for n, v in zip(names, r)}) + "\n")
        return block.num_rows
    if t == "PARQUET":
        from ..storage.fuse.block_io import write_block
        write_block(path, block)
        return block.num_rows
    if t == "ORC":
        import pyarrow.orc as paorc

        from ..storage.fuse.block_io import block_to_arrow
        paorc.write_table(block_to_arrow(block), path)
        return block.num_rows
    raise BadArguments(f"unsupported file format {t!r}")
