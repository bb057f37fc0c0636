"""Columnar containers.

TPU-native analog of the reference's arrow-style column layer
(reference: src/common/column/src/ + src/query/expression/src/values.rs).
Numeric, boolean, date/timestamp and vector columns are numpy arrays that
move to HBM unchanged (``jnp.asarray`` is zero conversion); strings are
arrow-layout offsets+bytes; validity is a boolean mask (True = valid).

Vector columns are ``[N, dim]`` fixed-width arrays — the layout batched
MXU distance kernels consume directly (reference stores them row-major
too: src/query/expression/src/types/vector.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from ..errors import BadDataValueType
from ..types import (
    ArrayType,
    Boolean,
    DataType,
    NullableType,
    NullType,
    NumberType,
    String,
    StringType,
    VectorType,
)


@dataclass
class StringData:
    """Arrow-layout binary column: ``data[offsets[i]:offsets[i+1]]`` is row i."""

    offsets: np.ndarray  # int64, len N+1
    data: np.ndarray  # uint8

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def as_object_array(self) -> np.ndarray:
        """Decoded values as a cached numpy object array (filter/compare
        kernels hit the same block's strings repeatedly; decode once)."""
        cache = getattr(self, "_obj_cache", None)
        if cache is None or len(cache) != len(self):
            const = getattr(self, "_const_value", None)
            if const is not None:  # literal broadcast: no per-row decode
                cache = np.full(len(self), const, dtype=object)
            else:
                cache = np.array(self._decode_all(), dtype=object)
            object.__setattr__(self, "_obj_cache", cache)
        return cache

    def is_ascii(self) -> bool:
        """True when every byte is ASCII — char positions == byte
        positions, so slicing kernels may run byte-level (cached)."""
        cache = getattr(self, "_ascii_cache", None)
        if cache is None:
            cache = bool(self.data.max(initial=0) < 128)
            object.__setattr__(self, "_ascii_cache", cache)
        return cache

    def codes(self):
        """Dense int64 codes via the native factorizer (cached), or None.
        Lets per-row kernels (LIKE/regexp) run once per UNIQUE value."""
        if getattr(self, "_const_value", None) is not None:
            return np.zeros(len(self), np.int64)
        cache = getattr(self, "_code_cache", None)
        if cache is not None and len(cache) == len(self):
            return cache
        from .. import native
        codes = native.factorize_strings(self.offsets, self.data)
        if codes is not None:
            object.__setattr__(self, "_code_cache", codes)
        return codes

    def dict_view(self):
        """(dictionary StringData, int64 codes) when cheaply available —
        codes already cached by a prior factorize — else None. The
        dictionary holds each distinct value once, in first-occurrence
        order, and is cached so every later take/compare on this column
        is an int-gather (the reference's dictionary fast path over
        low-cardinality string columns, src/common/hashtable short-string
        specialization)."""
        codes = getattr(self, "_code_cache", None)
        if codes is None or len(codes) != len(self):
            return None
        d = getattr(self, "_dict_cache", None)
        if d is None:
            n = len(self)
            n_uniq = int(codes.max()) + 1 if n else 0
            first = np.empty(n_uniq, np.int64)
            first[codes[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
            d = self._materialized_take(first)
            object.__setattr__(d, "_code_cache",
                               np.arange(n_uniq, dtype=np.int64))
            object.__setattr__(self, "_dict_cache", d)
        return d, codes

    @property
    def nbytes_est(self) -> int:
        return self.offsets.nbytes + self.data.nbytes

    @staticmethod
    def constant(value: str, n: int) -> "StringData":
        b = np.frombuffer(value.encode("utf-8"), np.uint8)
        s = StringData(np.arange(n + 1, dtype=np.int64) * len(b),
                       np.tile(b, n))
        object.__setattr__(s, "_const_value", value)
        return s

    @staticmethod
    def from_pylist(values: Sequence[Any]) -> "StringData":
        bufs = []
        offsets = np.zeros(len(values) + 1, dtype=np.int64)
        total = 0
        for i, v in enumerate(values):
            b = b"" if v is None else (v.encode("utf-8") if isinstance(v, str) else bytes(v))
            bufs.append(b)
            total += len(b)
            offsets[i + 1] = total
        data = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy() if total else np.zeros(0, np.uint8)
        return StringData(offsets, data)

    def get(self, i: int) -> str:
        return bytes(self.data[self.offsets[i]: self.offsets[i + 1]]).decode("utf-8", "replace")

    def to_pylist(self) -> list:
        cache = getattr(self, "_obj_cache", None)
        if cache is not None and len(cache) == len(self):
            return list(cache)
        return self._decode_all()

    def _decode_all(self) -> list:
        out = []
        offs = self.offsets
        mv = self.data.tobytes()
        for i in range(len(self)):
            out.append(mv[offs[i]: offs[i + 1]].decode("utf-8", "replace"))
        return out

    def take(self, indices: np.ndarray) -> "StringData":
        idx = np.asarray(indices, np.int64)
        # dictionary fast path: a take over a coded column is an int
        # gather — bytes materialize lazily only if something downstream
        # actually needs the arrow layout (join assembly almost never
        # does: group keys/compares ride the codes)
        dv = None
        if getattr(self, "_code_cache", None) is not None:
            dv = self.dict_view()
        elif len(idx) >= 32768 and len(self) >= 65536 \
                and getattr(self, "_const_value", None) is None:
            # large gather: byte repack costs more than one factorize
            if self.codes() is not None:
                dv = self.dict_view()
        if dv is not None:
            return DictStringData(dv[0], dv[1][idx])
        return self._materialized_take(idx)

    def _materialized_take(self, idx: np.ndarray) -> "StringData":
        from .. import native
        taken = native.take_strings(self.offsets, self.data, idx)
        if taken is not None:
            return StringData(taken[0], taken[1])
        lens = self.offsets[1:] - self.offsets[:-1]
        new_lens = lens[idx]
        new_offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(new_lens, out=new_offsets[1:])
        total = int(new_offsets[-1])
        n = len(self)
        # filter-shaped takes (strictly increasing indices — the common
        # case from block.filter) gather with ONE boolean byte mask
        # instead of three row-length int64 temporaries
        if len(idx) and total and np.all(np.diff(idx) > 0):
            keep = np.zeros(n, np.bool_)
            keep[idx] = True
            byte_keep = np.repeat(keep, lens)
            return StringData(new_offsets, self.data[byte_keep])
        if not total:
            return StringData(new_offsets, np.zeros(0, np.uint8))
        # general gather: for output byte k in row j,
        # src = row_start[j] + (k - out_start[j])
        within = np.arange(total, dtype=np.int64) - np.repeat(
            new_offsets[:-1], new_lens)
        src = np.repeat(self.offsets[idx], new_lens) + within
        return StringData(new_offsets, self.data[src])

    @staticmethod
    def concat(parts: Sequence["StringData"]) -> "StringData":
        if len(parts) > 1 and all(isinstance(p, DictStringData)
                                  for p in parts):
            d0 = parts[0]._dict
            if all(p._dict is d0 for p in parts[1:]):
                return DictStringData(
                    d0, np.concatenate([p._codes for p in parts]))
        n = sum(len(p) for p in parts)
        offsets = np.zeros(n + 1, dtype=np.int64)
        datas = []
        pos = 0
        base = 0
        for p in parts:
            ln = len(p)
            offsets[pos + 1: pos + ln + 1] = p.offsets[1:] + base
            base += int(p.offsets[-1])
            pos += ln
            datas.append(p.data)
        data = np.concatenate(datas) if datas else np.zeros(0, np.uint8)
        return StringData(offsets, data)


class DictStringData(StringData):
    """Dictionary-coded string column: row i's value is
    ``dict[codes[i]]``. The arrow (offsets, data) layout materializes
    lazily on first access, so take→take→group chains over coded columns
    never repack bytes — they gather int64 codes (the join-assembly hot
    path; reference keeps string columns dictionary-backed through its
    hash-join output for the same reason)."""

    def __init__(self, dict_sd: StringData, codes: np.ndarray):
        self._dict = dict_sd
        self._codes = np.asarray(codes, np.int64)
        self._mat: Optional[StringData] = None

    def _materialize(self) -> StringData:
        if self._mat is None:
            self._mat = self._dict._materialized_take(self._codes)
        return self._mat

    @property
    def offsets(self) -> np.ndarray:
        return self._materialize().offsets

    @property
    def data(self) -> np.ndarray:
        return self._materialize().data

    @property
    def nbytes_est(self) -> int:
        return self._codes.nbytes + self._dict.nbytes_est

    def __len__(self) -> int:
        return len(self._codes)

    def get(self, i: int) -> str:
        return self._dict.get(int(self._codes[i]))

    def as_object_array(self) -> np.ndarray:
        cache = getattr(self, "_obj_cache", None)
        if cache is None or len(cache) != len(self):
            cache = self._dict.as_object_array()[self._codes]
            object.__setattr__(self, "_obj_cache", cache)
        return cache

    def to_pylist(self) -> list:
        return self.as_object_array().tolist()

    def is_ascii(self) -> bool:
        return self._dict.is_ascii()

    def codes(self):
        # dictionary positions ARE dense comparable codes (some may be
        # unused after filtering — group/compare consumers pack them)
        return self._codes

    def dict_view(self):
        return self._dict, self._codes

    def take(self, indices: np.ndarray) -> "StringData":
        return DictStringData(self._dict,
                              self._codes[np.asarray(indices, np.int64)])


class Column:
    """A typed column: payload + optional validity mask.

    ``data`` is one of:
      * ``np.ndarray``  (numbers / bool / date / timestamp: 1-D;
        vectors: ``[N, dim]``)
      * ``StringData``  (VARCHAR)
      * ``(offsets: np.ndarray, child: Column)``  (ARRAY)
    """

    __slots__ = ("dtype", "data", "validity")

    def __init__(self, dtype: DataType, data, validity: Optional[np.ndarray] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        if validity is not None and not dtype.is_nullable():
            self.dtype = dtype.wrap_nullable()

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None) -> "Column":
        if dtype is None:
            dtype = _infer_dtype_from_numpy(arr)
        inner = dtype.remove_nullable()
        if isinstance(inner, VectorType):
            arr = np.ascontiguousarray(arr, dtype=inner.numpy_dtype())
            assert arr.ndim == 2 and arr.shape[1] == inner.dim, (arr.shape, inner.dim)
        elif isinstance(inner, (NumberType,)) or inner in (Boolean,):
            arr = np.ascontiguousarray(arr, dtype=inner.numpy_dtype())
        return Column(dtype, arr, validity)

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType) -> "Column":
        inner = dtype.remove_nullable()
        has_none = any(v is None for v in values)
        validity = None
        if has_none:
            validity = np.array([v is not None for v in values], dtype=np.bool_)
            dtype = dtype.wrap_nullable()
        if isinstance(inner, StringType):
            return Column(dtype, StringData.from_pylist(values), validity)
        from ..types import DecimalType, GeometryType, VariantType
        if isinstance(inner, DecimalType):
            import decimal
            q = inner.quantum()
            payload = np.empty(len(values), object)
            with decimal.localcontext() as dctx:
                # default context precision (28) is below DECIMAL(76)
                dctx.prec = max(inner.precision + inner.scale + 4, 80)
                for i, v in enumerate(values):
                    payload[i] = (decimal.Decimal(0) if v is None
                                  else decimal.Decimal(str(v)).quantize(q))
            return Column(dtype, payload, validity)
        from ..types import BinaryType, BitmapType
        if isinstance(inner, (GeometryType, BinaryType, BitmapType)):
            # text-payload host types: WKT / hex / canonical int-set text
            texts = [None if v is None else str(v) for v in values]
            return Column(dtype, StringData.from_pylist(texts), validity)
        if isinstance(inner, VariantType):
            import json as _json
            texts = [None if v is None
                     else (v if isinstance(v, str)
                           else _json.dumps(v, separators=(",", ":")))
                     for v in values]
            return Column(dtype, StringData.from_pylist(texts), validity)
        if isinstance(inner, VectorType):
            dim = inner.dim
            out = np.zeros((len(values), dim), dtype=inner.numpy_dtype())
            for i, v in enumerate(values):
                if v is not None:
                    a = np.asarray(v, dtype=inner.numpy_dtype())
                    if a.shape != (dim,):
                        raise BadDataValueType(f"vector dim mismatch: expected {dim}, got {a.shape}")
                    out[i] = a
            return Column(dtype, out, validity)
        from ..types import MapType, TupleType
        if isinstance(inner, (MapType, TupleType)):
            payload = np.empty(len(values), object)
            for i, v in enumerate(values):
                payload[i] = v
            return Column(dtype, payload, validity)
        if isinstance(inner, ArrayType):
            offsets = np.zeros(len(values) + 1, dtype=np.int64)
            flat: list = []
            for i, v in enumerate(values):
                items = [] if v is None else list(v)
                flat.extend(items)
                offsets[i + 1] = len(flat)
            child = Column.from_pylist(flat, inner.inner)
            return Column(dtype, (offsets, child), validity)
        from ..types.datatype import DateType, TimestampType
        if isinstance(inner, (DateType, TimestampType)) and \
                any(isinstance(v, str) for v in values):
            import datetime as _dt
            epoch = _dt.date(1970, 1, 1)
            parsed = []
            for v in values:
                if v is None:
                    parsed.append(0)
                elif isinstance(v, str):
                    if isinstance(inner, DateType):
                        parsed.append((_dt.date.fromisoformat(v[:10])
                                       - epoch).days)
                    else:
                        ts = _dt.datetime.fromisoformat(v).replace(
                            tzinfo=_dt.timezone.utc)
                        parsed.append(int(ts.timestamp() * 1_000_000))
                else:
                    parsed.append(v)
            return Column(dtype, np.asarray(parsed, inner.numpy_dtype()),
                          validity)
        np_dtype = inner.numpy_dtype()
        filled = [0 if v is None else v for v in values]
        return Column(dtype, np.asarray(filled, dtype=np_dtype), validity)

    @staticmethod
    def null_column(n: int) -> "Column":
        from ..types import Null
        return Column(Null, np.zeros(n, np.float64), np.zeros(n, np.bool_))

    # ------------------------------------------------------------------ basics
    def __len__(self) -> int:
        if isinstance(self.data, np.ndarray):
            return self.data.shape[0]
        if isinstance(self.data, StringData):
            return len(self.data)
        return len(self.data[0]) - 1

    def is_nullable(self) -> bool:
        return self.validity is not None

    def null_count(self) -> int:
        return 0 if self.validity is None else int((~self.validity).sum())

    def get(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        inner = self.dtype.remove_nullable()
        if isinstance(self.data, StringData):
            return self.data.get(i)
        if isinstance(inner, VectorType):
            return self.data[i]
        if isinstance(inner, ArrayType):
            offs, child = self.data
            return [child.get(j) for j in range(int(offs[i]), int(offs[i + 1]))]
        v = self.data[i]
        return v.item() if hasattr(v, "item") else v

    def to_pylist(self) -> list:
        inner = self.dtype.remove_nullable()
        if isinstance(self.data, StringData):
            vals = self.data.to_pylist()
        elif isinstance(inner, VectorType):
            vals = [row.tolist() for row in self.data]
        elif isinstance(inner, ArrayType):
            vals = [self.get(i) for i in range(len(self))]
            return vals if self.validity is None else [
                v if ok else None for v, ok in zip(vals, self.validity)]
        else:
            vals = self.data.tolist()
        if self.validity is not None:
            vals = [v if ok else None for v, ok in zip(vals, self.validity)]
        return vals

    # ------------------------------------------------------------------ kernels
    def take(self, indices) -> "Column":
        indices = np.asarray(indices, dtype=np.int64)
        validity = self.validity[indices] if self.validity is not None else None
        if isinstance(self.data, StringData):
            return Column(self.dtype, self.data.take(indices), validity)
        inner = self.dtype.remove_nullable()
        if isinstance(inner, ArrayType):
            return Column.from_pylist([self.get(int(i)) for i in indices], self.dtype)
        return Column(self.dtype, self.data[indices], validity)

    def slice(self, start: int, end: int) -> "Column":
        validity = self.validity[start:end] if self.validity is not None else None
        if isinstance(self.data, DictStringData):
            return Column(self.dtype,
                          DictStringData(self.data._dict,
                                         self.data._codes[start:end]),
                          validity)
        if isinstance(self.data, StringData):
            offs = self.data.offsets[start: end + 1].copy()
            data = self.data.data[offs[0]: offs[-1]].copy()
            offs -= offs[0]
            return Column(self.dtype, StringData(offs, data), validity)
        inner = self.dtype.remove_nullable()
        if isinstance(inner, ArrayType):
            return self.take(np.arange(start, end))
        return Column(self.dtype, self.data[start:end], validity)

    def filter(self, mask: np.ndarray) -> "Column":
        return self.take(np.nonzero(np.asarray(mask, dtype=np.bool_))[0])

    @staticmethod
    def concat(parts: Sequence["Column"]) -> "Column":
        parts = list(parts)
        assert parts, "concat of zero columns"
        dtype = parts[0].dtype
        any_valid = any(p.validity is not None for p in parts)
        validity = None
        if any_valid:
            validity = np.concatenate([
                p.validity if p.validity is not None else np.ones(len(p), np.bool_)
                for p in parts])
            dtype = dtype.wrap_nullable()
        if isinstance(parts[0].data, StringData):
            return Column(dtype, StringData.concat([p.data for p in parts]), validity)
        inner = dtype.remove_nullable()
        if isinstance(inner, ArrayType):
            vals: list = []
            for p in parts:
                vals.extend(p.to_pylist())
            return Column.from_pylist(vals, dtype)
        return Column(dtype, np.concatenate([p.data for p in parts]), validity)

    # ------------------------------------------------------------------ numeric view
    def numpy(self) -> np.ndarray:
        """Raw payload for numeric/vector columns (nulls hold garbage)."""
        assert isinstance(self.data, np.ndarray), f"numpy() on {self.dtype}"
        return self.data

    def __repr__(self) -> str:  # pragma: no cover
        return f"Column({self.dtype}, n={len(self)}, nulls={self.null_count()})"


def _infer_dtype_from_numpy(arr: np.ndarray) -> DataType:
    from ..types import (Boolean, Float32, Float64, Int8, Int16, Int32, Int64,
                         UInt8, UInt16, UInt32, UInt64)
    if arr.ndim == 2:
        elem = "i8" if arr.dtype == np.int8 else "f32"
        return VectorType(arr.shape[1], elem)
    table = {
        np.dtype(np.bool_): Boolean,
        np.dtype(np.int8): Int8, np.dtype(np.int16): Int16,
        np.dtype(np.int32): Int32, np.dtype(np.int64): Int64,
        np.dtype(np.uint8): UInt8, np.dtype(np.uint16): UInt16,
        np.dtype(np.uint32): UInt32, np.dtype(np.uint64): UInt64,
        np.dtype(np.float32): Float32, np.dtype(np.float64): Float64,
    }
    if arr.dtype in table:
        return table[arr.dtype]
    raise BadDataValueType(f"cannot infer type from numpy dtype {arr.dtype}")
