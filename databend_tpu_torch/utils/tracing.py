"""Query tracing spans.

Reference analog: fastrace spans on the query path (planner.rs:98
``#[fastrace::trace]``), exported over OTLP and surfaced through the
system_history tables (src/common/tracing). Here: an in-process span
recorder — ``span("bind")`` context managers nest via a contextvar, each
query's tree lands in its query_log entry, and ``system.trace_spans``
exposes the recent flat span list. Export stays in-process (zero-egress
image); the OTLP wire format would hang off ``SpanRecorder.drain``.

While ``torch.profiler`` records, a span is also a ``record_function``
range named ``dbt.<name>`` on the calling thread: a host event on the
profiler's clock, around the device work it enqueues. With the profiler
off a span costs one check more. Span names use ``_``:
``system.query_execution`` reads a dotted path as an operator.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
from typing import Any, Dict, List, Optional

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "dbtpu_span", default=None)

MAX_SPANS = 4096


class Span:
    __slots__ = ("name", "start", "end", "parent", "query_id", "attrs")

    def __init__(self, name: str, parent: Optional["Span"], query_id: str):
        self.name = name
        self.parent = parent
        self.query_id = query_id
        self.start = time.perf_counter()
        self.end = self.start
        self.attrs: Dict[str, Any] = {}

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def path(self) -> str:
        parts = []
        node: Optional[Span] = self
        while node is not None:
            parts.append(node.name)
            node = node.parent
        return "/".join(reversed(parts))


class SpanRecorder:
    """Process-wide ring of finished spans."""

    def __init__(self, capacity: int = MAX_SPANS):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self.capacity = capacity

    def record(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[Span]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out


RECORDER = SpanRecorder()
_QUERY_ID: contextvars.ContextVar = contextvars.ContextVar(
    "dbtpu_span_qid", default="")


def set_query_id(qid: str):
    return _QUERY_ID.set(qid)


def current_query_id():
    return _QUERY_ID.get() or None


def reset_query_id(token) -> None:
    _QUERY_ID.reset(token)


def current_span() -> Optional[Span]:
    """The innermost open span of this context, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Nested timing span; records on exit (even on error, with the
    exception type attached like the reference's span events). While the
    profiler records, also the range ``dbt.<name>``."""
    parent = _CURRENT.get()
    s = Span(name, parent, _QUERY_ID.get())
    s.attrs.update(attrs)
    token = _CURRENT.set(s)
    rng = record_function("dbt." + name) if _profiler_enabled() else None
    if rng is not None:
        rng.__enter__()
    try:
        yield s
    except BaseException as e:
        s.attrs["error"] = type(e).__name__
        raise
    finally:
        if rng is not None:
            rng.__exit__(None, None, None)
        s.end = time.perf_counter()
        _CURRENT.reset(token)
        RECORDER.record(s)
