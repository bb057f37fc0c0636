"""Process metrics registry (reference: src/common/metrics/src/metrics/ —
prometheus counters/histograms incl. the vector-pruning counters used at
vector_index_pruner.rs:186-229). Exposed over HTTP at /metrics in
prometheus text format."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.histograms: Dict[str, List[float]] = defaultdict(list)

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float):
        with self._lock:
            h = self.histograms[name]
            h.append(value)
            if len(h) > 10000:
                del h[: len(h) // 2]

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            for k, v in self.histograms.items():
                if v:
                    out[f"{k}_count"] = len(v)
                    out[f"{k}_sum"] = sum(v)
            return out

    def prometheus_text(self) -> str:
        lines = []
        for k, v in sorted(self.snapshot().items()):
            lines.append(f"databend_tpu_{k} {v}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()
