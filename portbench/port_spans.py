"""The port's own spans in a traced record.

While ``torch.profiler`` records, the port's ``utils/tracing.span`` also
enters ``record_function("dbt.<name>")``, so each span is a host event
named ``dbt.<name>`` among the record's ``cpu`` rows, on the profiler's
clock. The readers of these spans (``metrics/knn_*_ms.py``) sum such events
on the thread that ran the benchmark's ``portbench.batch`` spans, inside
the window, and give ms a batch. A record without device items (a run of
the plain path on the CPU) has no card for the host to wait on or feed:
they stay silent there, as the device readers do, and so does a record of
a port that opens no such span.
"""

from __future__ import annotations

from .devtrace import SPAN_PREFIX, in_window

PREFIX = "dbt."


def ms_a_batch(record, names) -> float | None:
    """Summed ms of the ``dbt.<name>`` events for ``name`` in ``names`` on
    the batches' thread in the window, over ``record["batches"]``; None
    where there is none."""
    window, cpu = record.get("window_us"), record.get("cpu")
    if not window or not cpu or not record.get("device") \
            or not record.get("batches"):
        return None
    thread = next((r[4] for r in cpu if r[0] == SPAN_PREFIX + "batch"), None)
    want = {PREFIX + n for n in names}
    took = [r[2] - r[1] for r in in_window(cpu, window)
            if r[0] in want and r[4] == thread]
    if not took:
        return None
    return sum(took) / 1e3 / record["batches"]
