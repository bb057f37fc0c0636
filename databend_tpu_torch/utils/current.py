"""Current-session context (thread/task-local).

The binder and evaluator need session-scoped services for a small set of
functions (nextval(), dict_get(), temp-table resolution) without threading
the session through every expression constructor. Follows the same
contextvar pattern as utils/memstat.py and utils/tracing.py.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Any, Optional

_CURRENT_SESSION: ContextVar[Optional[Any]] = ContextVar(
    "databend_tpu_session", default=None)


def set_session(session) -> object:
    return _CURRENT_SESSION.set(session)


def reset_session(token) -> None:
    _CURRENT_SESSION.reset(token)


def current_session():
    return _CURRENT_SESSION.get()
