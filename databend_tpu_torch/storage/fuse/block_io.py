"""Block data IO: DataBlock <-> parquet via pyarrow.

Analog of the reference's block serialization (reference:
src/query/storages/fuse/src/io/write/block_writer.rs:116). Vector columns
map to arrow FixedSizeList so the on-disk format stays arrow-compatible;
reads reassemble the `[N, dim]` contiguous layout the TPU kernels want.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ...expression import Column, DataBlock, StringData
from ...expression.schema import TableSchema
from ...types import (ArrayType, Boolean, DataType, Date, DecimalType,
                      GeometryType, NumberType, String, StringType, Timestamp,
                      TupleType, VariantType, VectorType)


def _to_arrow_array(col: Column) -> pa.Array:
    inner = col.dtype.remove_nullable()
    mask = None if col.validity is None else ~col.validity  # arrow: True = null
    if isinstance(inner, VectorType):
        flat = pa.array(np.ascontiguousarray(col.data).reshape(-1),
                        type=pa.float32() if inner.element == "f32" else pa.int8())
        arr = pa.FixedSizeListArray.from_arrays(flat, inner.dim)
        if mask is not None and mask.any():
            # rebuild with nulls (FixedSizeListArray.from_arrays has no mask param)
            indices = pa.array(np.where(col.validity, np.arange(len(col)), -1),
                               type=pa.int64())
            arr = arr.take(pa.array(
                np.where(col.validity, np.arange(len(col)), len(col) - 1), type=pa.int64()))
            arr = pa.Array.from_pandas(arr.to_pandas())  # fallback: rare path
        return arr
    if isinstance(inner, (StringType, VariantType, GeometryType)):
        return pa.array(col.data.to_pylist(), type=pa.string(),
                        mask=mask if mask is not None else None)
    if isinstance(inner, TupleType):
        # tuples persist as JSON text (decoded back on read)
        import json as _json
        texts = [None if v is None else _json.dumps(list(v), default=str)
                 for v in col.to_pylist()]
        return pa.array(texts, type=pa.string())
    if isinstance(inner, DecimalType):
        return pa.array(col.data.tolist(),
                        type=pa.decimal128(min(inner.precision, 38), inner.scale),
                        mask=mask if mask is not None else None)
    if isinstance(inner, ArrayType):
        return pa.array(col.to_pylist())
    return pa.array(col.data, mask=mask)


def _from_arrow_array(arr: pa.ChunkedArray | pa.Array, dtype: DataType) -> Column:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    inner = dtype.remove_nullable()
    validity = None
    if arr.null_count > 0:
        validity = np.asarray(arr.is_valid())
    if isinstance(inner, VectorType):
        flat = np.asarray(arr.values.to_numpy(zero_copy_only=False))
        data = flat.reshape(len(arr), inner.dim).astype(inner.numpy_dtype(), copy=False)
        return Column(dtype if validity is None else dtype.wrap_nullable(), data, validity)
    if isinstance(inner, (StringType, VariantType, GeometryType)):
        return Column.from_pylist(arr.to_pylist(), dtype)
    if isinstance(inner, DecimalType):
        import numpy as _np
        vals = arr.to_pylist()
        payload = _np.empty(len(vals), object)
        import decimal as _d
        for i, v in enumerate(vals):
            payload[i] = _d.Decimal(0) if v is None else v
        return Column(dtype, payload, validity)
    if isinstance(inner, ArrayType):
        return Column.from_pylist(arr.to_pylist(), dtype)
    if isinstance(inner, TupleType):
        import json as _json
        vals = [None if v is None else tuple(_json.loads(v))
                for v in arr.to_pylist()]
        return Column.from_pylist(vals, dtype)
    data = arr.to_numpy(zero_copy_only=False)
    if validity is not None and data.dtype.kind == "f" and \
            inner.numpy_dtype().kind != "f":
        data = np.nan_to_num(data, nan=0)  # nulls decode as NaN floats
    return Column(dtype, np.ascontiguousarray(data, dtype=inner.numpy_dtype()), validity)


def arrow_schema_to_fields(schema: pa.Schema) -> List:
    """Map an arrow schema to DataFields (parquet/ORC schema inference)."""
    from ...expression.schema import DataField
    from ...types import (Float32, Float64, Int8, Int16, Int32, Int64, UInt8,
                          UInt16, UInt32, UInt64, Variant)
    out = []
    for f in schema:
        t = f.type
        if pa.types.is_fixed_size_list(t) and pa.types.is_float32(t.value_type):
            dt = VectorType(t.list_size)
        elif pa.types.is_boolean(t):
            dt = Boolean
        elif pa.types.is_integer(t):
            dt = {"int8": Int8, "int16": Int16, "int32": Int32,
                  "int64": Int64, "uint8": UInt8, "uint16": UInt16,
                  "uint32": UInt32, "uint64": UInt64}[str(t)]
        elif pa.types.is_float32(t):
            dt = Float32
        elif pa.types.is_floating(t):
            dt = Float64
        elif pa.types.is_decimal(t):
            dt = DecimalType(t.precision, t.scale)
        elif pa.types.is_date(t):
            dt = Date
        elif pa.types.is_timestamp(t):
            dt = Timestamp
        elif pa.types.is_string(t) or pa.types.is_large_string(t) \
                or pa.types.is_binary(t):
            dt = String
        elif pa.types.is_list(t) or pa.types.is_struct(t) or pa.types.is_map(t):
            dt = Variant
        else:
            dt = String
        out.append(DataField(f.name, dt.wrap_nullable() if f.nullable
                             and not dt.is_nullable() else dt))
    return out


def block_to_arrow(block: DataBlock) -> pa.Table:
    """DataBlock -> arrow Table (Flight/IPC interchange)."""
    arrays = [_to_arrow_array(c) for c in block.columns]
    return pa.table(dict(zip(block.names, arrays)))


def write_block(path: str, block: DataBlock) -> int:
    """Write a DataBlock as parquet; returns file size in bytes."""
    import io

    from ..operator import OPERATOR
    table = block_to_arrow(block)
    buf = io.BytesIO()
    pq.write_table(table, buf, compression="zstd")
    data = buf.getvalue()
    OPERATOR.write_bytes(path, data)
    return len(data)


def read_block(path: str, schema: TableSchema,
               projection: Optional[List[str]] = None) -> DataBlock:
    """Schema-evolution-aware block read: columns renamed after the block
    was written resolve through DataField.prior_names; columns added after
    fill with the field default / NULL (reference: column-id resolution +
    default backfill in the fuse reader)."""
    names = projection if projection is not None else schema.field_names()
    names = [schema.field(n).name for n in names]
    from ..operator import OPERATOR
    handle = OPERATOR.open_read(path)
    file_cols = set(pq.read_schema(handle).names)
    resolved = {}  # field name -> on-disk name (or None: backfill)
    for n in names:
        f = schema.field(n)
        disk = n if n in file_cols else next(
            (p for p in reversed(f.prior_names) if p in file_cols), None)
        resolved[n] = disk
    want = sorted({d for d in resolved.values() if d is not None})
    table = pq.read_table(handle, columns=want) if want else None
    n_rows = table.num_rows if table is not None else read_block_rows(path)
    cols = []
    for n in names:
        f = schema.field(n)
        disk = resolved[n]
        if disk is not None:
            cols.append(_from_arrow_array(table.column(disk), f.dtype))
        else:
            from ...expression.evaluator import constant_column
            if f.default is not None:
                cols.append(constant_column(f.default, f.dtype, n_rows))
            else:
                cols.append(constant_column(None, f.dtype.wrap_nullable(),
                                            n_rows))
    return DataBlock(names, cols, n_rows)


def read_block_rows(path: str) -> int:
    return pq.read_metadata(path).num_rows
