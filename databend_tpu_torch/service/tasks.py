"""Scheduled tasks (CREATE TASK).

Reference analog: src/query/task_support + cloud_control task client —
CREATE TASK name SCHEDULE = n SECOND AS <sql>, suspended on creation,
ALTER TASK RESUME starts it. Embedded version: tasks persist in the meta
KV; an optional daemon scheduler thread fires due tasks; EXECUTE TASK
runs one immediately. Run history feeds SHOW TASKS / system.task_history.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..errors import _err

UnknownTask = _err("UnknownTask", 2611)
TaskAlreadyExists = _err("TaskAlreadyExists", 2612)


def _cron_period_secs(cron: str) -> int:
    """Rough period from a 5/6-field cron spec: */n minutes -> n*60, a
    fixed minute -> hourly, otherwise daily."""
    fields = cron.split()
    minute = fields[1] if len(fields) == 6 else fields[0] if fields else "*"
    if minute.startswith("*/"):
        try:
            return max(1, int(minute[2:])) * 60
        except ValueError:
            return 3600
    if minute == "*":
        return 60
    return 3600


def _key(name: str) -> str:
    return f"tasks/{name.lower()}"


class TaskManager:
    def __init__(self, session):
        self.s = session
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.history: List[dict] = []  # (name, started, duration_ms, error)

    # ----------------------------------------------------------------- crud
    def create(self, name: str, schedule_secs: int, sql: str,
               if_not_exists: bool = False, warehouse: str = None,
               cron: str = None, comment: str = None, after=None,
               when: str = None, suspend_after_failures: int = None):
        cur, _ = self.s.meta.get(_key(name))
        if cur is not None:
            if if_not_exists:
                return
            raise TaskAlreadyExists(f"task {name!r} already exists")
        if cron is not None and schedule_secs == 0:
            # embedded scheduler has no cron wheel: approximate the beat
            # from the cron minute field (reference tasks run server-side)
            schedule_secs = _cron_period_secs(cron)
        self.s.meta.upsert(_key(name), {
            "name": name.lower(), "schedule_secs": schedule_secs,
            "sql": sql, "state": "SUSPENDED", "last_run": 0.0,
            "warehouse": warehouse or "", "cron": cron or "",
            "comment": comment or "", "after": list(after or []),
            "when": when or "",
            "suspend_after_failures": suspend_after_failures or 0,
            "consecutive_failures": 0})

    def drop(self, name: str, if_exists: bool = False):
        cur, _ = self.s.meta.get(_key(name))
        if cur is None:
            if if_exists:
                return
            raise UnknownTask(f"unknown task {name!r}")
        self.s.meta.delete(_key(name))

    def get(self, name: str) -> dict:
        v, _ = self.s.meta.get(_key(name))
        if v is None:
            raise UnknownTask(f"unknown task {name!r}")
        return v

    def list(self) -> List[dict]:
        return [v for _, v, _ in self.s.meta.list_prefix("tasks/")]

    def set_state(self, name: str, state: str):
        t = self.get(name)
        t["state"] = state
        self.s.meta.upsert(_key(name), t)

    # ------------------------------------------------------------ execution
    def execute(self, name: str):
        t = self.get(name)
        started = time.time()
        err = None
        try:
            self.s.sql(t["sql"])
        except Exception as e:  # task errors are recorded, not raised
            err = str(e)
        self.history.append({"name": t["name"], "started": started,
                             "duration_ms": (time.time() - started) * 1e3,
                             "error": err})
        if len(self.history) > 1000:
            del self.history[:len(self.history) - 1000]
        t["last_run"] = started
        self.s.meta.upsert(_key(name), t)
        if err is not None:
            raise UnknownTask(f"task {name!r} failed: {err}") from None

    def run_due(self) -> int:
        """Fire every STARTED task whose schedule elapsed; returns count."""
        fired = 0
        for t in self.list():
            if t["state"] != "STARTED":
                continue
            if time.time() - t.get("last_run", 0) >= t["schedule_secs"]:
                try:
                    self.execute(t["name"])
                except Exception:
                    pass
                fired += 1
        return fired

    def start_scheduler(self, poll_secs: float = 1.0):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(poll_secs):
                self.run_due()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_scheduler(self):
        if self._thread is not None:
            self._stop.set()
            self._thread = None
