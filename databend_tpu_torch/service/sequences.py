"""Sequences: monotone id allocators backed by the meta KV.

Reference: CREATE/DROP SEQUENCE + nextval() —
src/query/service/src/interpreters/interpreter_sequence_{create,drop}.rs,
src/meta/app/src/schema/sequence.rs (SequenceMeta: current/start/step),
nextval lowering in src/query/sql/src/planner/binder (async function).

Allocation is block-at-a-time: one CAS bump of ``current`` hands out
``n`` consecutive values for an n-row block, matching the reference's
batched nextval semantics (values within one statement are consecutive;
concurrent statements may interleave ranges).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import SequenceError, UnknownSequence

_PREFIX = "sequences/"


@dataclass
class SequenceInfo:
    name: str
    start: int = 1
    step: int = 1
    current: int = 1  # next value to hand out
    comment: str = ""
    created_ts: float = 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "step": self.step,
                "current": self.current, "comment": self.comment,
                "created_ts": self.created_ts}

    @staticmethod
    def from_dict(d: dict) -> "SequenceInfo":
        return SequenceInfo(d["name"], d.get("start", 1), d.get("step", 1),
                            d.get("current", d.get("start", 1)),
                            d.get("comment", ""), d.get("created_ts", 0.0))


class SequenceManager:
    def __init__(self, meta):
        self.meta = meta

    def create(self, name: str, start: int = 1, step: int = 1,
               comment: str = "", if_not_exists: bool = False,
               or_replace: bool = False) -> None:
        if step <= 0:
            raise SequenceError("sequence step must be positive")
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is not None and not or_replace:
            if if_not_exists:
                return
            raise SequenceError(f"sequence {name!r} already exists")
        info = SequenceInfo(name, start, step, start, comment, time.time())
        self.meta.upsert(key, info.to_dict())

    def drop(self, name: str, if_exists: bool = False) -> None:
        key = _PREFIX + name.lower()
        got, _ = self.meta.get(key)
        if got is None:
            if if_exists:
                return
            raise UnknownSequence(f"unknown sequence {name!r}")
        self.meta.delete(key)

    def get(self, name: str) -> SequenceInfo:
        got, _ = self.meta.get(_PREFIX + name.lower())
        if got is None:
            raise UnknownSequence(f"unknown sequence {name!r}")
        return SequenceInfo.from_dict(got)

    def list(self) -> List[SequenceInfo]:
        return sorted((SequenceInfo.from_dict(v) for _, v, _
                       in self.meta.list_prefix(_PREFIX)),
                      key=lambda s: s.name)

    def next_block(self, name: str, n: int) -> np.ndarray:
        """Allocate n consecutive values with a CAS retry loop (the
        embedded-KV analog of the reference's meta txn bump)."""
        key = _PREFIX + name.lower()
        for _attempt in range(64):
            got, seq = self.meta.get(key)
            if got is None:
                raise UnknownSequence(f"unknown sequence {name!r}")
            info = SequenceInfo.from_dict(got)
            first = info.current
            info.current = first + info.step * max(n, 1)
            try:
                self.meta.upsert(key, info.to_dict(), expected_seq=seq)
            except Exception:
                continue  # lost the race: reread and retry
            return first + info.step * np.arange(n, dtype=np.int64)
        raise SequenceError(f"nextval({name}) contention: CAS retries exhausted")
