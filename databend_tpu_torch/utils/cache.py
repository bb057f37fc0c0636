"""LRU caches (reference: src/query/storages/common/cache — CacheManager's
named in-memory caches; the vector-column cache plays the role of the
reference's VectorIndexFileCache, caches.rs:57-58, but holds HBM-resident
device arrays so repeated searches never re-read object storage)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional


class LruCache:
    def __init__(self, capacity_bytes: int = 1 << 30,
                 sizeof: Optional[Callable[[Any], int]] = None):
        self.capacity = capacity_bytes
        self.sizeof = sizeof or (lambda v: getattr(v, "nbytes", 1))
        self._d: OrderedDict = OrderedDict()
        self._size = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key][0]
            self.misses += 1
            return None

    def put(self, key, value):
        size = self.sizeof(value)
        with self._lock:
            if key in self._d:
                self._size -= self._d[key][1]
            self._d[key] = (value, size)
            self._d.move_to_end(key)
            self._size += size
            while self._size > self.capacity and len(self._d) > 1:
                _, (_, sz) = self._d.popitem(last=False)
                self._size -= sz

    def get_or_load(self, key, loader: Callable[[], Any]):
        v = self.get(key)
        if v is None:
            v = loader()
            self.put(key, v)
        return v

    def invalidate(self, key):
        with self._lock:
            if key in self._d:
                _, sz = self._d.pop(key)
                self._size -= sz

    def clear(self):
        with self._lock:
            self._d.clear()
            self._size = 0

    def __len__(self):
        return len(self._d)


class CacheManager:
    """Named cache registry (reference: caches.rs:29-73)."""

    _instance: Optional["CacheManager"] = None

    def __init__(self):
        # device-array cache for block vector columns (and normalized variants)
        self.vector_columns = LruCache(capacity_bytes=8 << 30)
        # deserialized HNSW graphs
        self.vector_indexes = LruCache(capacity_bytes=4 << 30,
                                       sizeof=lambda g: g.nbytes())
        # bloom filters
        self.bloom_filters = LruCache(capacity_bytes=512 << 20,
                                      sizeof=lambda f: f.bits.nbytes)
        # inverted index readers
        self.inverted_indexes = LruCache(capacity_bytes=2 << 30,
                                         sizeof=lambda r: getattr(r, "nbytes", 1 << 20))
        # parquet block cache (DataBlock)
        self.blocks = LruCache(capacity_bytes=4 << 30,
                               sizeof=lambda b: sum(
                                   getattr(c.data, "nbytes", 1 << 10) for c in b.columns))

    @classmethod
    def instance(cls) -> "CacheManager":
        if cls._instance is None:
            cls._instance = CacheManager()
        return cls._instance

    def clear_all(self):
        for c in (self.vector_columns, self.vector_indexes, self.bloom_filters,
                  self.inverted_indexes, self.blocks):
            c.clear()
