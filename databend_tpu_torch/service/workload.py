"""Workload groups: per-group concurrency / memory / timeout quotas.

Reference: EE resource management (src/query/ee/src/resource_management/,
workload groups in src/common/base/src/runtime/workload_group/) — named
quota bundles attached to warehouses; every query running under the
warehouse is admitted through the group's concurrency slot, capped at
the group's memory quota, and killed past its timeout.

Here: `CREATE WORKLOAD GROUP g WITH max_concurrency=.. memory_quota=..
query_timeout=..`, attached via `CREATE WAREHOUSE w WITH
workload_group='g'` + `USE WAREHOUSE w`. Enforcement happens in
SessionContext.sql(): admission through a process-wide per-group
semaphore, MemStat limit = min(session limit, group quota), deadline =
min(session timeout, group timeout).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..errors import BadArguments
from ..utils.memstat import QueryQueue

_PREFIX = "workload_groups/"

_KNOWN_OPTS = {"max_concurrency", "memory_quota", "query_timeout",
               "queue_timeout", "cpu_quota", "comment"}

# process-wide admission queues: (group, max_concurrency) -> QueryQueue.
# Keyed by the quota value so ALTERing a group swaps in a fresh semaphore.
_QUEUES: Dict[Tuple[str, int, float], QueryQueue] = {}
_QUEUES_LOCK = threading.Lock()


def parse_bytes(v: str) -> int:
    """'1048576', '64MB', '2GB', '50%' (of nothing measurable here ->
    rejected; the reference sizes % against the node's memory)."""
    s = str(v).strip().upper()
    if s.endswith("%"):
        raise BadArguments(
            "percentage memory_quota needs a fixed node size; give bytes"
            " or KB/MB/GB")
    for suf, mul in (("KB", 1 << 10), ("MB", 1 << 20), ("GB", 1 << 30),
                     ("TB", 1 << 40), ("B", 1)):
        if s.endswith(suf):
            return int(float(s[:-len(suf)]) * mul)
    return int(s)


def _validate(opts: Dict[str, str]) -> None:
    for k in opts:
        if k not in _KNOWN_OPTS:
            raise BadArguments(
                f"unknown workload group option {k!r}"
                f" (known: {', '.join(sorted(_KNOWN_OPTS))})")
    if "max_concurrency" in opts and int(opts["max_concurrency"]) < 0:
        raise BadArguments("max_concurrency must be >= 0")
    if "memory_quota" in opts:
        parse_bytes(opts["memory_quota"])
    for k in ("query_timeout", "queue_timeout", "cpu_quota"):
        if k in opts:
            float(opts[k])


class WorkloadManager:
    def __init__(self, session):
        self.meta = session.meta

    def create(self, name: str, opts: Dict[str, str],
               if_not_exists: bool = False) -> None:
        _validate(opts)
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is not None:
            if if_not_exists:
                return
            raise BadArguments(f"workload group {name!r} already exists")
        self.meta.upsert(key, {"name": name, "options": dict(opts),
                               "created_ts": time.time()})

    def alter(self, name: str, opts: Dict[str, str]) -> None:
        _validate(opts)
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            raise BadArguments(f"unknown workload group {name!r}")
        got["options"].update(opts)
        self.meta.upsert(key, got)

    def drop(self, name: str, if_exists: bool = False) -> None:
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise BadArguments(f"unknown workload group {name!r}")
        self.meta.delete(key)

    def get(self, name: str) -> Optional[dict]:
        got, _ = self.meta.get(_PREFIX + name.lower())
        return got

    def list(self) -> List[dict]:
        return sorted((v for _, v, _ in self.meta.list_prefix(_PREFIX)),
                      key=lambda g: g["name"])


def effective_group(session) -> Optional[dict]:
    """The workload group of the session's current warehouse, if any."""
    wh = getattr(session, "current_warehouse", None)
    if not wh:
        return None
    got, _ = session.meta.get(f"warehouses/{wh.lower()}")
    if not got:
        return None
    gname = got.get("options", {}).get("workload_group")
    if not gname:
        return None
    grp, _ = session.meta.get(_PREFIX + gname.lower())
    return grp


def group_queue(grp: dict) -> Optional[QueryQueue]:
    """Process-wide admission queue for the group's max_concurrency."""
    opts = grp.get("options", {})
    mc = int(opts.get("max_concurrency") or 0)
    if mc <= 0:
        return None
    qt = float(opts.get("queue_timeout") or 60.0)
    key = (grp["name"].lower(), mc, qt)
    with _QUEUES_LOCK:
        q = _QUEUES.get(key)
        if q is None:
            q = QueryQueue(mc, qt)
            _QUEUES[key] = q
        return q
