"""Separated global runtimes.

The reference splits its tokio runtimes: GlobalIORuntime for storage
IO, the query pipeline executor's worker pool for CPU work, and the
pruning runtime for index-driven block elimination
(src/common/base/src/runtime + fuse_pruner.rs:386). The analog here is
three bounded, independently named thread pools, so slow block IO can
never starve pruning (or vice versa) and each surface is observable by
thread name. Device compute never runs on these pools — it is XLA's
async stream; the pools cover the host-side seams only.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_POOLS: Dict[str, ThreadPoolExecutor] = {}
_LOCK = threading.Lock()

_SIZES = {
    "io": 4,        # block read/prefetch (GlobalIORuntime analog)
    "pruning": 4,   # bloom/ngram/index filter loads (pruning runtime)
    "query": 2,     # misc host-side query work
}


def pool(kind: str) -> ThreadPoolExecutor:
    p = _POOLS.get(kind)
    if p is None:
        with _LOCK:
            p = _POOLS.get(kind)
            if p is None:
                p = ThreadPoolExecutor(
                    max_workers=_SIZES.get(kind, 2),
                    thread_name_prefix=f"dbtpu-{kind}")
                _POOLS[kind] = p
    return p
