"""The traced window: ``torch.profiler`` over the measured batches, turned
into the record that the per-layer readers (``metrics/<name>.py``) read.

A record holds plain lists, so a reader can be tested on a recorded one:

- ``device``: ``[name, start_us, end_us]`` of every kernel, copy and memset
  the card ran in the window (the profiler's device-side events, without
  the device copies of user annotations);
- ``cpu``: ``[name, start_us, end_us, input_shapes, thread]`` of the
  host's events: aten ops and CUDA runtime calls (shapes only for
  ``aten::mm``) and the benchmark's own spans, named ``portbench.<span>``;
- ``window_us``: the first batch's start and the last batch's end;
- ``batches``, ``counters``, ``spans``, ``config``, ``mix``: filled in by the
  harness (the last two: the cell's configuration and traffic mix).
"""

from __future__ import annotations

SPAN_PREFIX = "portbench."
PRODUCT = "aten::mm"      # the op whose input shapes the record keeps


def capture(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and device activities,
    the input shapes of each op) and return ``(fn(), record)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts, record_shapes=True) as prof:
        out = fn()
        if card:
            torch.cuda.synchronize()
    return out, summarize(prof.events())


def summarize(events) -> dict:
    """The record's ``device``, ``cpu`` and ``window_us`` from the
    profiler's events."""
    from torch.autograd import DeviceType
    device, cpu = [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(SPAN_PREFIX):
                continue
            device.append([e.name, start, end])
        elif e.device_type == DeviceType.CPU:
            shapes = e.input_shapes if e.name == PRODUCT else None
            cpu.append([e.name, start, end,
                        [list(s) for s in shapes] if shapes else None,
                        e.thread])
    device.sort(key=lambda r: r[1])
    cpu.sort(key=lambda r: r[1])
    batches = [r for r in cpu if r[0] == SPAN_PREFIX + "batch"]
    window = [batches[0][1], batches[-1][2]] if batches else None
    return {"device": device, "cpu": cpu, "window_us": window}


def in_window(rows, window):
    """The rows that start inside ``window`` (the device may finish a
    batch's last item after the host's span ends: it is kept)."""
    lo, hi = window
    return [r for r in rows if lo <= r[1] <= hi]


def products(record) -> list:
    """``(b, d, n)`` of each 2-D ``aten::mm`` in the traced window."""
    out = []
    for name, _, _, shapes, _ in in_window(record["cpu"], record["window_us"]):
        if name == PRODUCT and shapes and len(shapes) >= 2 \
                and len(shapes[0]) == 2 and len(shapes[1]) == 2:
            (b, d), (_, n) = shapes[0], shapes[1]
            out.append((b, d, n))
    return out


def busy_intervals(record) -> list:
    """The union of the device's busy intervals in the window, clipped to
    it: overlapping items (streams, copies beside kernels) count once."""
    lo, hi = record["window_us"]
    out = []
    for _, s, e in in_window(record["device"], record["window_us"]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(record) -> float:
    return sum(e - s for s, e in busy_intervals(record))


def device_ops(record, top: int = 10) -> list:
    """``[[name, seconds], ...]``: device time by item name in the window,
    the largest first."""
    by = {}
    for name, s, e in in_window(record["device"], record["window_us"]):
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[_short(n), v] for n, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(record, top: int = 10) -> list:
    """``[[label, seconds], ...]``: the window's idle device time split by
    what the host was doing meanwhile, the largest first. The label is the
    benchmark's span that was open (``between`` outside every span) and the
    innermost host op inside it (``host``: Python between ops), on the
    thread that ran the batches."""
    lo, hi = record["window_us"]
    gaps, t = [], lo
    for s, e in busy_intervals(record):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    by = {}
    segs = host_segments(record)
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, label = segs[k]
            over = min(g1, s1) - max(g0, s0)
            if over > 0:
                by[label] = by.get(label, 0.0) + over / 1e6
            k += 1
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def host_segments(record) -> list:
    """``[(start_us, end_us, label)]`` covering the window: what the thread
    that ran the batches was doing, by its innermost event (see
    ``idle_gaps``)."""
    lo, hi = record["window_us"]
    cpu = record["cpu"]
    thread = next((r[4] for r in cpu if r[0] == SPAN_PREFIX + "batch"), None)
    points = []
    for i, r in enumerate(cpu):
        if r[4] == thread and r[2] > r[1] and r[2] > lo and r[1] < hi:
            points.append((max(r[1], lo), 1, i))
            points.append((min(r[2], hi), 0, i))
    points.sort()
    segs, open_, t = [], [], lo
    for p, kind, i in points:
        if p > t:
            segs.append((t, p, _label(cpu, open_)))
            t = p
        if kind:
            open_.append(i)
        else:
            open_.remove(i)
    if hi > t:
        segs.append((t, hi, _label(cpu, open_)))
    return segs


def _label(cpu, open_) -> str:
    span, op = "between", None
    for i in reversed(open_):
        name = cpu[i][0]
        if name.startswith(SPAN_PREFIX):
            span = name[len(SPAN_PREFIX):]
            break
        op = op or name
    return f"{span}:{op or 'host'}"


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width] + "..."
