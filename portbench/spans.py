"""The benchmark's own spans, around its calls into each layer of the port.

Each span is kept on the host clock (``time.perf_counter``); in a traced
run it is also a ``torch.profiler.record_function`` range named
``portbench.<span>``, which labels the device's idle gaps
(``devtrace.idle_gaps``). Spans inside the port are not the benchmark's to
add.
"""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.done = []          # (name, start_s, end_s)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function("portbench." + name)
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.done.append((name, t0, time.perf_counter()))

    def seconds(self) -> dict:
        """Each span's summed seconds by name."""
        out = {}
        for name, t0, t1 in self.done:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out
