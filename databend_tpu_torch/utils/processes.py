"""Running-query registry + KILL support.

Reference: the session process list (SHOW PROCESSLIST / system.processes)
and `KILL QUERY <id>` (parser statement.rs kill_stmt; interpreter sets the
query's abort flag). Here: a process-wide registry of running queries with
an abort event each; the executor polls it between pipeline blocks (the
same cadence as the deadline check).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

_LOCK = threading.Lock()
_RUNNING: Dict[str, dict] = {}


def register(query_id: str, sql: str, user: str) -> None:
    with _LOCK:
        _RUNNING[query_id] = {"sql": sql, "user": user,
                              "start": time.time(),
                              "abort": threading.Event()}


def unregister(query_id: str) -> None:
    with _LOCK:
        _RUNNING.pop(query_id, None)


def kill(query_id: str) -> bool:
    with _LOCK:
        entry = _RUNNING.get(query_id)
    if entry is None:
        return False
    entry["abort"].set()
    return True


def is_aborted(query_id: Optional[str]) -> bool:
    if query_id is None:
        return False
    with _LOCK:
        entry = _RUNNING.get(query_id)
    return entry is not None and entry["abort"].is_set()


def list_running() -> List[dict]:
    with _LOCK:
        return [{"id": qid, "sql": e["sql"], "user": e["user"],
                 "start": e["start"]} for qid, e in _RUNNING.items()]
