"""One caller in a closed loop of query batches through a prepared KNN
statement's ``execute_batch_block``.

The mix (``traffic/<mix>.json``) gives ``statement``, ``batch`` (queries a
call), ``placeholders`` (each query vector is bound to this many ``?``),
``exact`` and ``warm_batches``. Batch ``i`` asks the pool's queries ``i *
batch`` onwards, wrapping round the pool, so every seed sends the same
sizes in the same order. Each batch is timed from the call to the return
of its result block, which is in host memory; the caller sends the next
batch only after that. Nothing is cached between batches by the caller.
"""

from __future__ import annotations

import time

import numpy as np


def prepare(ctx, mix: dict):
    """The prepared statement the window drives."""
    return ctx.prepare(mix["statement"])


class Feed:
    """The pool's queries (the data's ``queries``) in turn, ``batch`` at a
    time."""

    def __init__(self, data: dict, mix: dict):
        self.pool, self.batch = data["queries"], mix["batch"]
        self.placeholders = mix["placeholders"]
        self.pos = 0

    def next(self):
        """(pool positions ``[batch]``, the statement's parameter sets)."""
        idx = (self.pos + np.arange(self.batch)) % len(self.pool)
        self.pos = (self.pos + self.batch) % len(self.pool)
        q = self.pool[idx]
        return idx, [(v,) * self.placeholders for v in q]


def _one(target, feed: Feed, exact: bool) -> dict:
    idx, params = feed.next()
    t0 = time.perf_counter()
    res = target.execute_batch_block(params, exact=exact)
    t1 = time.perf_counter()
    blk = res.block
    return {"t0": t0, "t1": t1, "pool": idx,
            "query_index": np.asarray(blk.column("query_index").numpy()),
            "id": np.asarray(blk.column("id").numpy()),
            "d": np.asarray(blk.column("d").numpy())}


def warm(target, feed: Feed, mix: dict, spans) -> list:
    """The warm-up batches: the first answers one batch and loads the
    corpus (span ``load``), the rest warm every shape the window uses."""
    out = []
    with spans("load"):
        out.append(_one(target, feed, mix["exact"]))
    with spans("warm"):
        for _ in range(mix["warm_batches"] - 1):
            out.append(_one(target, feed, mix["exact"]))
    return out


def window(target, feed: Feed, mix: dict, seconds: float, spans) -> list:
    """Batches until ``seconds`` have passed since the first began; the
    window is the first batch's start to the last batch's end."""
    out = []
    start = time.perf_counter()
    while True:
        with spans("batch"):
            out.append(_one(target, feed, mix["exact"]))
        if out[-1]["t1"] - start >= seconds:
            return out


def attempted(batches: list) -> int:
    """Queries asked in the window."""
    return sum(len(b["pool"]) for b in batches)


def end_to_end(batches: list) -> dict:
    """``qps``: every query answered in the window over its seconds;
    ``batch_p95_ms``: the 95th percentile (linear between ranks) of every
    batch's latency."""
    span = batches[-1]["t1"] - batches[0]["t0"]
    lat = np.array([b["t1"] - b["t0"] for b in batches]) * 1e3
    return {"qps": attempted(batches) / span,
            "batch_p95_ms": float(np.percentile(lat, 95)),
            "window_s": span}
