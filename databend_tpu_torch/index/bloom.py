"""Per-block membership filters for point-predicate pruning.

Analog of the reference's xor8 / BinaryFuse32 bloom index
(reference: src/query/storages/common/index/src/bloom_index.rs:192,
filters/xor8/). A classic split-bloom with vectorized numpy hashing is
used instead of xor filters: build is one pass of splitmix64 mixing
(vectorized), membership is k masked bit tests — both orders of magnitude
off the query critical path (pruning happens per block, not per row).
False-positive rate ~0.8% at 10 bits/key, k=7.
"""

from __future__ import annotations

import io
import zlib
from typing import Iterable, Optional

import numpy as np

_K = 7  # hash functions
_BITS_PER_KEY = 10


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def _hash_values(values, dtype_kind: str) -> np.ndarray:
    """Stable 64-bit hashes for a column payload."""
    if dtype_kind == "string":
        return np.array([zlib.crc32(v.encode("utf-8")) if v is not None else 0
                         for v in values], dtype=np.uint64)
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        # normalize -0.0/+0.0, then bit-pattern hash
        arr = np.where(arr == 0.0, 0.0, arr)
        return arr.astype(np.float64).view(np.uint64)
    return arr.astype(np.int64).view(np.uint64)


class BloomFilter:
    def __init__(self, bits: np.ndarray, num_bits: int):
        self.bits = bits  # uint64 words
        self.num_bits = num_bits

    @staticmethod
    def build(hashes: np.ndarray) -> "BloomFilter":
        n = max(len(hashes), 1)
        num_bits = max(64, 1 << int(np.ceil(np.log2(n * _BITS_PER_KEY))))
        words = np.zeros(num_bits // 64, dtype=np.uint64)
        h = _splitmix64(hashes)
        mask = np.uint64(num_bits - 1)
        for i in range(_K):
            hi = _splitmix64(h + np.uint64(i * 0x9E3779B9))
            pos = (hi & mask).astype(np.int64)
            np.bitwise_or.at(words, pos >> 6, np.uint64(1) << (pos & 63).astype(np.uint64))
        return BloomFilter(words, num_bits)

    def contains_hash(self, h: int) -> bool:
        h = _splitmix64(np.array([h], dtype=np.uint64))[0]
        mask = np.uint64(self.num_bits - 1)
        for i in range(_K):
            hi = _splitmix64(np.array([h + np.uint64(i * 0x9E3779B9)], np.uint64))[0]
            pos = int(hi & mask)
            if not (int(self.bits[pos >> 6]) >> (pos & 63)) & 1:
                return False
        return True

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(buf, bits=self.bits, num_bits=np.int64(self.num_bits))
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "BloomFilter":
        z = np.load(io.BytesIO(data))
        return BloomFilter(z["bits"], int(z["num_bits"]))


def build_column_bloom(col) -> Optional[BloomFilter]:
    """Build a bloom filter for a Column (strings + integer families)."""
    from ..expression.column import StringData
    from ..types import NumberType, StringType
    inner = col.dtype.remove_nullable()
    if isinstance(inner, StringType):
        data = col.data
        if isinstance(data, StringData):
            full = data.codes()
            if full is not None and len(full):
                # dictionary path: the filter's membership set is the set
                # of DISTINCT values — hash each unique once (no per-row
                # decode/crc32; low-cardinality ingest goes ~100x). Rows
                # with the same code carry identical bytes, so any
                # representative row of a code works.
                sel = full if col.validity is None \
                    else full[np.asarray(col.validity, bool)]
                if not len(sel):
                    return BloomFilter.build(np.zeros(0, np.uint64))
                n_u = int(full.max()) + 1
                rep = np.empty(n_u, np.int64)
                rep[full[::-1]] = np.arange(len(full) - 1, -1, -1)
                uniq_vals = [data.get(int(rep[c]))
                             for c in np.unique(sel)]
                return BloomFilter.build(_hash_values(uniq_vals, "string"))
        vals = [v for v in col.to_pylist() if v is not None]
        return BloomFilter.build(_hash_values(vals, "string"))
    if isinstance(inner, NumberType) and inner.is_integer():
        data = col.data if col.validity is None else col.data[col.validity]
        return BloomFilter.build(_hash_values(data, "int"))
    return None


def hash_literal(value, dtype) -> Optional[int]:
    from ..types import NumberType, StringType
    inner = dtype.remove_nullable()
    if isinstance(inner, StringType) and isinstance(value, str):
        return int(_hash_values([value], "string")[0])
    if isinstance(inner, NumberType) and inner.is_integer() \
            and isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        return int(_hash_values([value], "int")[0])
    return None
