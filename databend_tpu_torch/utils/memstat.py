"""Query memory accounting + admission control.

Host-side analog of the reference's memory runtime: ``MemStat`` +
``LimitMemGuard`` (reference: src/common/base/src/runtime/memory/) track
per-query allocations against a limit so a runaway GROUP BY/JOIN fails the
QUERY instead of OOM-killing the process, and ``QueriesQueueManager``
(reference: src/query/service/src/sessions/queue_mgr.rs) bounds how many
queries execute concurrently.

TPU-native framing: device (HBM) residency is managed by the LRU caches in
``utils/cache.py`` with byte budgets; this module accounts the HOST side —
the operator buffers (sort/aggregate/join state) that the reference tracks
through ThreadTracker. Operators report buffered blocks via
``track_block``; the spilling operators consult the same stat to decide
when to go external.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Optional

import numpy as np

from ..errors import MemoryLimitExceeded


def block_bytes(block) -> int:
    """Approximate host bytes of a DataBlock (numpy payloads + string
    buffers + validity bitmaps)."""
    total = 0
    for col in block.columns:
        data = col.data
        if isinstance(data, np.ndarray):
            total += data.nbytes
        elif hasattr(data, "nbytes_est"):  # StringData
            total += data.nbytes_est
        else:
            total += 8 * len(col)
        if col.validity is not None:
            total += col.validity.nbytes
    return total


class MemStat:
    """Hierarchical-enough memory counter: alloc/free with a hard limit."""

    def __init__(self, limit_bytes: int = 0, name: str = "query"):
        self.limit = int(limit_bytes)
        self.name = name
        self.current = 0
        self.peak = 0
        self._lock = threading.Lock()

    def alloc(self, nbytes: int) -> None:
        with self._lock:
            self.current += int(nbytes)
            if self.current > self.peak:
                self.peak = self.current
            if self.limit and self.current > self.limit:
                cur = self.current
                raise MemoryLimitExceeded(
                    f"{self.name}: memory limit exceeded: {cur} bytes used, "
                    f"limit {self.limit} (set max_memory_usage to raise)")

    def free(self, nbytes: int) -> None:
        with self._lock:
            self.current = max(0, self.current - int(nbytes))

    def track_block(self, block) -> int:
        n = block_bytes(block)
        self.alloc(n)
        return n


_CURRENT: contextvars.ContextVar[Optional[MemStat]] = contextvars.ContextVar(
    "dbtpu_memstat", default=None)


def current_memstat() -> Optional[MemStat]:
    return _CURRENT.get()


def set_memstat(stat: Optional[MemStat]):
    """Install the query's MemStat; returns a token for reset()."""
    return _CURRENT.set(stat)


def reset_memstat(token) -> None:
    _CURRENT.reset(token)


def track_block(block) -> int:
    """Charge a buffered block to the active query's MemStat (no-op when
    no stat is installed). Returns the charged byte count."""
    stat = _CURRENT.get()
    if stat is None:
        return 0
    return stat.track_block(block)


def free_bytes(nbytes: int) -> None:
    stat = _CURRENT.get()
    if stat is not None:
        stat.free(nbytes)


class QueryQueue:
    """Admission control: at most ``max_running`` queries execute at once;
    waiters time out with a queue error (reference QueriesQueueManager)."""

    def __init__(self, max_running: int = 0, timeout_secs: float = 60.0):
        self.max_running = int(max_running)
        self.timeout_secs = timeout_secs
        self._sem = (threading.BoundedSemaphore(self.max_running)
                     if self.max_running > 0 else None)

    def acquire(self) -> bool:
        if self._sem is None:
            return True
        if not self._sem.acquire(timeout=self.timeout_secs):
            from ..errors import QueueTimeout
            raise QueueTimeout(
                f"query queued longer than {self.timeout_secs}s "
                f"({self.max_running} queries already running)")
        return True

    def release(self) -> None:
        if self._sem is not None:
            self._sem.release()
