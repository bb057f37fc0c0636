"""Logical type system.

TPU-native re-design of the reference's typed column system
(reference: src/query/expression/src/types/*.rs). Key differences from the
Rust original:

* Numeric columns are numpy arrays on the host and ``jnp`` arrays on device;
  the logical type carries the numpy dtype so host<->device moves are zero
  conversion.
* ``VectorType(dim, element)`` mirrors ``VectorDataType::{Int8,Float32}(dim)``
  (reference: src/query/expression/src/types/vector.rs:229-232); vector
  columns are ``[N, dim]`` fixed-width arrays, the layout the MXU wants.
* Nullability is a wrapper type (``NullableType``) carried next to a validity
  bitmap, like the reference's ``Nullable<T>``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..errors import SyntaxException, TypeMismatch


class DataType:
    """Base class for all logical types. Instances are immutable."""

    def numpy_dtype(self) -> np.dtype:
        raise NotImplementedError(type(self).__name__)

    def sql_name(self) -> str:
        raise NotImplementedError

    # -- nullability helpers -------------------------------------------------
    def is_nullable(self) -> bool:
        return False

    def wrap_nullable(self) -> "DataType":
        return NullableType(self)

    def remove_nullable(self) -> "DataType":
        return self

    def is_numeric(self) -> bool:
        return False

    def is_integer(self) -> bool:
        return False

    def is_float(self) -> bool:
        return False

    def __repr__(self) -> str:
        return self.sql_name()

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self) -> int:
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class NullType(DataType):
    def sql_name(self) -> str:
        return "NULL"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(np.float64)

    def is_nullable(self) -> bool:
        return True


class BooleanType(DataType):
    def sql_name(self) -> str:
        return "BOOLEAN"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(np.bool_)


@dataclass(frozen=True, eq=False)
class NumberType(DataType):
    """All fixed-width numbers. ``kind`` in {i8,i16,i32,i64,u8,u16,u32,u64,f32,f64}."""

    kind: str

    _NP = {
        "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
        "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
        "f32": np.float32, "f64": np.float64,
    }
    _SQL = {
        "i8": "TINYINT", "i16": "SMALLINT", "i32": "INT", "i64": "BIGINT",
        "u8": "TINYINT UNSIGNED", "u16": "SMALLINT UNSIGNED",
        "u32": "INT UNSIGNED", "u64": "BIGINT UNSIGNED",
        "f32": "FLOAT", "f64": "DOUBLE",
    }

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(self._NP[self.kind])

    def sql_name(self) -> str:
        return self._SQL[self.kind]

    def is_numeric(self) -> bool:
        return True

    def is_integer(self) -> bool:
        return self.kind[0] in ("i", "u")

    def is_signed(self) -> bool:
        return self.kind[0] in ("i", "f")

    def is_float(self) -> bool:
        return self.kind[0] == "f"

    def bit_width(self) -> int:
        return int(self.kind[1:])


class StringType(DataType):
    def sql_name(self) -> str:
        return "VARCHAR"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


class DateType(DataType):
    """Days since unix epoch, int32 (reference: types/date.rs)."""

    def sql_name(self) -> str:
        return "DATE"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(np.int32)

    def is_numeric(self) -> bool:
        return False


class TimestampType(DataType):
    """Microseconds since unix epoch, int64 (reference: types/timestamp.rs)."""

    def sql_name(self) -> str:
        return "TIMESTAMP"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclass(frozen=True, eq=False, repr=False)
class DecimalType(DataType):
    """Exact fixed-point numbers (reference: types/decimal.rs — i128/i256
    backed). Host-side payload is python decimal.Decimal in an object
    array: exact semantics for money columns; never enters device kernels."""
    precision: int = 38
    scale: int = 2

    def sql_name(self) -> str:
        return f"DECIMAL({self.precision}, {self.scale})"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)

    def is_numeric(self) -> bool:
        return True

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))

    def quantum(self):
        import decimal
        return decimal.Decimal(1).scaleb(-self.scale)


class VariantType(DataType):
    """Semi-structured JSON values stored as canonical JSON text
    (reference: jsonb-backed Variant, src/query/expression/src/types/
    variant.rs). Host-side type — never enters device kernels."""

    def sql_name(self) -> str:
        return "VARIANT"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


class BinaryType(DataType):
    """Byte strings stored as lowercase hex text payloads (reference:
    src/query/expression/src/types/binary.rs; sqllogictest renders BINARY
    as hex, which makes hex the natural canonical encoding here).
    Host-side type — never enters device kernels."""

    def sql_name(self) -> str:
        return "BINARY"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


class BitmapType(DataType):
    """Integer sets stored as canonical sorted ``"1,2,3"`` text payloads
    (reference: roaring-bitmap-backed Bitmap,
    src/query/expression/src/types/bitmap.rs; the text form is exactly
    the reference's to_string rendering). Host-side type."""

    def sql_name(self) -> str:
        return "BITMAP"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


class GeometryType(DataType):
    """Planar geometries as WKT text (reference: geozero-backed Geometry,
    src/query/expression/src/types/geometry.rs). Subset: POINT fully
    supported (constructors/accessors/distance); other WKT round-trips."""

    def sql_name(self) -> str:
        return "GEOMETRY"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


@dataclass(frozen=True, eq=False)
class VectorType(DataType):
    """Fixed-dim vector; element is Float32 or Int8.

    Mirrors ``VectorDataType`` (reference: src/query/expression/src/types/
    vector.rs:229-232). Stored as an ``[N, dim]`` array — HBM-friendly.
    """

    dim: int
    element: str = "f32"  # "f32" | "i8"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(np.float32 if self.element == "f32" else np.int8)

    def sql_name(self) -> str:
        if self.element == "f32":
            return f"VECTOR({self.dim})"
        return f"VECTOR({self.dim}, INT8)"


@dataclass(frozen=True, eq=False)
class ArrayType(DataType):
    inner: DataType

    def sql_name(self) -> str:
        return f"ARRAY({self.inner.sql_name()})"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


@dataclass(frozen=True, eq=False)
class MapType(DataType):
    """MAP(K, V) — per-row python dicts, host-side (reference:
    src/query/expression/src/types/map.rs; kv pairs never enter device
    kernels)."""

    key: DataType = None
    value: DataType = None

    def sql_name(self) -> str:
        return f"MAP({self.key.sql_name()}, {self.value.sql_name()})"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


@dataclass(frozen=True, eq=False)
class TupleType(DataType):
    fields: tuple
    names: tuple = ()  # optional field names (TUPLE(id INT, name STRING))

    def sql_name(self) -> str:
        if self.names and any(not n.isdigit() for n in self.names):
            return "TUPLE(" + ", ".join(
                f"{n} {f.sql_name()}"
                for n, f in zip(self.names, self.fields)) + ")"
        return "TUPLE(" + ", ".join(f.sql_name() for f in self.fields) + ")"

    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)


@dataclass(frozen=True, eq=False)
class NullableType(DataType):
    inner: DataType

    def __post_init__(self):
        assert not isinstance(self.inner, NullableType)

    def sql_name(self) -> str:
        return f"{self.inner.sql_name()} NULL"

    def numpy_dtype(self) -> np.dtype:
        return self.inner.numpy_dtype()

    def is_nullable(self) -> bool:
        return True

    def wrap_nullable(self) -> DataType:
        return self

    def remove_nullable(self) -> DataType:
        return self.inner

    def is_numeric(self) -> bool:
        return self.inner.is_numeric()

    def is_integer(self) -> bool:
        return self.inner.is_integer()

    def is_float(self) -> bool:
        return self.inner.is_float()


# Singletons
Null = NullType()
Boolean = BooleanType()
Int8 = NumberType("i8")
Int16 = NumberType("i16")
Int32 = NumberType("i32")
Int64 = NumberType("i64")
UInt8 = NumberType("u8")
UInt16 = NumberType("u16")
UInt32 = NumberType("u32")
UInt64 = NumberType("u64")
Float32 = NumberType("f32")
Float64 = NumberType("f64")
String = StringType()
Date = DateType()
Timestamp = TimestampType()
Variant = VariantType()
Geometry = GeometryType()
Binary = BinaryType()
Bitmap = BitmapType()

ALL_NUMBER_TYPES = [Int8, Int16, Int32, Int64, UInt8, UInt16, UInt32, UInt64, Float32, Float64]

_NUMERIC_RANK = {k: i for i, k in enumerate(
    ["u8", "i8", "u16", "i16", "u32", "i32", "u64", "i64", "f32", "f64"])}


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Smallest type both arguments cast to losslessly-enough for SQL semantics.

    Mirrors the reference's ``common_super_type`` used for comparison/arith
    coercion (reference: src/query/expression/src/type_check.rs).
    """
    nullable = a.is_nullable() or b.is_nullable()
    ai, bi = a.remove_nullable(), b.remove_nullable()
    if isinstance(ai, NullType):
        return b.wrap_nullable()
    if isinstance(bi, NullType):
        return a.wrap_nullable()
    if ai == bi:
        out = ai
    elif isinstance(ai, DecimalType) or isinstance(bi, DecimalType):
        d, o = (ai, bi) if isinstance(ai, DecimalType) else (bi, ai)
        if isinstance(o, DecimalType):
            out = DecimalType(max(d.precision, o.precision),
                              max(d.scale, o.scale))
        elif isinstance(o, NumberType) and o.is_integer():
            out = d
        elif isinstance(o, NumberType):
            out = Float64  # decimal with float degrades to f64
        else:
            raise TypeMismatch(f"no common super type for {ai} and {bi}")
    elif isinstance(ai, NumberType) and isinstance(bi, NumberType):
        out = _super_number(ai, bi)
    elif isinstance(ai, StringType) or isinstance(bi, StringType):
        o = bi if isinstance(ai, StringType) else ai
        if isinstance(o, NumberType):
            # reference type_check.rs: String+float -> the float type,
            # String+int -> DECIMAL(38, 5)
            out = o if o.is_float() else DecimalType(38, 5)
        else:
            out = String
    else:
        raise TypeMismatch(f"no common super type for {ai} and {bi}")
    return out.wrap_nullable() if nullable else out


def _super_number(a: NumberType, b: NumberType) -> NumberType:
    if a.is_float() or b.is_float():
        float_bits = max(t.bit_width() for t in (a, b) if t.is_float())
        int_bits = max((t.bit_width() for t in (a, b) if not t.is_float()), default=0)
        # ints wider than f32's 24-bit mantissa force f64
        return Float64 if (float_bits == 64 or int_bits >= 32) else Float32
    # both integers
    if a.is_signed() == b.is_signed():
        w = max(a.bit_width(), b.bit_width())
        pfx = "i" if a.is_signed() else "u"
        return NumberType(f"{pfx}{w}")
    # mixed sign: widen to signed of next width
    w = max(a.bit_width(), b.bit_width())
    w = min(w * 2, 64) if (a.bit_width() if not a.is_signed() else b.bit_width()) >= w else w
    return NumberType(f"i{max(w, 16)}") if w < 64 else Int64


_TYPE_NAMES = {
    "BOOLEAN": Boolean, "BOOL": Boolean,
    "TINYINT": Int8, "INT8": Int8,
    "SMALLINT": Int16, "INT16": Int16,
    "INT": Int32, "INTEGER": Int32, "INT32": Int32,
    "BIGINT": Int64, "INT64": Int64,
    "UINT8": UInt8, "UINT16": UInt16, "UINT32": UInt32, "UINT64": UInt64,
    "TINYINT UNSIGNED": UInt8, "SMALLINT UNSIGNED": UInt16,
    "INT UNSIGNED": UInt32, "INTEGER UNSIGNED": UInt32,
    "BIGINT UNSIGNED": UInt64,
    "FLOAT": Float32, "FLOAT32": Float32,
    "DOUBLE": Float64, "FLOAT64": Float64,
    "VARCHAR": String, "STRING": String, "TEXT": String,
    "DATE": Date,
    "TIMESTAMP": Timestamp, "DATETIME": Timestamp,
    "VARIANT": Variant, "JSON": Variant,
    "GEOMETRY": Geometry,
    "BINARY": Binary, "VARBINARY": Binary,
    "BITMAP": Bitmap,
    # `SELECT NULL` has type NULL; CTAS over it round-trips the name
    "NULL": Null, "NOTHING": Null,
}

# length/precision arguments on scalar names are accepted and ignored
# (reference dialect: VARCHAR(50), CHAR(8), DATETIME(0), TIMESTAMP(6))
_PARAM_SCALAR_RE = re.compile(
    r"^(VARCHAR|CHAR|CHARACTER|STRING|TEXT|BINARY|VARBINARY|DATETIME"
    r"|TIMESTAMP)\s*\(\s*\d+\s*\)$", re.I)

_VECTOR_RE = re.compile(r"^VECTOR\s*\(\s*(\d+)\s*(?:,\s*(INT8|FLOAT32)\s*)?\)$", re.I)
_ARRAY_RE = re.compile(r"^ARRAY\s*\((.*)\)$", re.I | re.S)
_DECIMAL_RE = re.compile(
    r"^(?:DECIMAL|NUMERIC)\s*(?:\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\))?$", re.I)


def parse_type_name(name: str) -> DataType:
    """Parse an SQL type name, e.g. from CREATE TABLE."""
    s = name.strip()
    up = s.upper()
    nullable = False
    if up.endswith(" NULL") and not up.endswith("NOT NULL"):
        nullable = True
        s = s[: -len(" NULL")].strip()
        up = s.upper()
    elif up.endswith("NOT NULL"):
        s = s[: -len("NOT NULL")].strip()
        up = s.upper()
    if up.startswith("NULLABLE(") and up.endswith(")"):
        # ClickHouse-compatible wrapper: Nullable(Int32)
        return parse_type_name(s[len("NULLABLE("):-1]).wrap_nullable()
    m = _PARAM_SCALAR_RE.match(up)
    if m:
        base = {"CHAR": "VARCHAR", "CHARACTER": "VARCHAR"}.get(
            m.group(1).upper(), m.group(1).upper())
        ty0 = _TYPE_NAMES[base]
        return ty0.wrap_nullable() if nullable else ty0
    ty: DataType
    if up in _TYPE_NAMES:
        ty = _TYPE_NAMES[up]
    else:
        m = _DECIMAL_RE.match(up)
        if m:
            p = int(m.group(1)) if m.group(1) else 38
            sc = int(m.group(2)) if m.group(2) else 0
            return (DecimalType(p, sc).wrap_nullable() if nullable
                    else DecimalType(p, sc))
        m = _VECTOR_RE.match(up)
        if m:
            elem = "i8" if (m.group(2) or "").upper() == "INT8" else "f32"
            ty = VectorType(int(m.group(1)), elem)
        else:
            m = _ARRAY_RE.match(s)
            if m:
                ty = ArrayType(parse_type_name(m.group(1)))
            elif up.startswith("TUPLE(") and up.endswith(")"):
                # TUPLE(a INT, b STRING) or TUPLE(INT, STRING): named
                # fields keep only the types (reference tuple types)
                inner = s[6:-1]
                parts, depth, start = [], 0, 0
                for i, ch in enumerate(inner):
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                    elif ch == "," and depth == 0:
                        parts.append(inner[start:i])
                        start = i + 1
                parts.append(inner[start:])
                fields, names = [], []
                for k, p in enumerate(parts):
                    p = p.strip()
                    toks = p.split(None, 1)
                    try:
                        fields.append(parse_type_name(p))
                        names.append(str(k + 1))
                    except SyntaxException:
                        if len(toks) == 2:
                            fields.append(parse_type_name(toks[1]))
                            names.append(toks[0])
                        else:
                            raise
                ty = TupleType(tuple(fields), tuple(names))
            elif up.startswith("MAP(") and up.endswith(")"):
                inner = s[4:-1]
                depth = 0
                for i, ch in enumerate(inner):
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                    elif ch == "," and depth == 0:
                        ty = MapType(parse_type_name(inner[:i]),
                                     parse_type_name(inner[i + 1:]))
                        break
                else:
                    raise SyntaxException(f"unknown type name: {name!r}")
            else:
                raise SyntaxException(f"unknown type name: {name!r}")
    return ty.wrap_nullable() if nullable else ty
