"""On-demand query profiling + flamegraph rendering.

Reference analog: ``EXPLAIN PERF <sql>`` runs the query under a pprof
sampling profiler at 99 Hz and returns one HTML row embedding a
flamegraph SVG (interpreter_explain_perf.rs:85-122,
src/common/base/src/runtime/perf/query_perf.rs:72-115 and the
flamegraph_*_template.html files). The TPU-native build has no perf(1)
or pprof; the equivalent is a Python stack-sampling profiler over
``sys._current_frames()`` — it sees the host orchestration (parse,
bind, optimize, host operators, device dispatch) which is exactly the
part not already covered by XLA's own profiler. The SVG layout is the
standard flamegraph (width = inclusive samples, one layer per frame),
rendered by an original generator below.
"""

from __future__ import annotations

import html as _html
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_HZ = 99


class SamplingProfiler:
    """Samples every live Python thread's stack at ``hz`` until stopped.

    Folded-stack aggregation happens at sample time (cheap: one dict
    update per thread per tick), so memory stays bounded regardless of
    how long the capture runs.
    """

    def __init__(self, hz: int = DEFAULT_HZ,
                 only_thread: Optional[int] = None):
        self.interval = 1.0 / max(1, hz)
        self.only_thread = only_thread
        self.folded: Dict[Tuple[str, ...], int] = {}
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- capture
    def _stack_of(self, frame) -> Tuple[str, ...]:
        parts: List[str] = []
        depth = 0
        while frame is not None and depth < 128:
            code = frame.f_code
            name = code.co_name
            fn = code.co_filename
            # compress module paths to package-relative names
            i = fn.rfind("databend_tpu_torch/")
            if i >= 0:
                fn = fn[i:]
            else:
                fn = fn.rsplit("/", 1)[-1]
            parts.append(f"{name} ({fn}:{frame.f_lineno})")
            frame = frame.f_back
            depth += 1
        return tuple(reversed(parts))

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            frames = sys._current_frames()
            self.samples += 1
            for tid, frame in frames.items():
                if tid == me:
                    continue
                if self.only_thread is not None and tid != self.only_thread:
                    continue
                stack = self._stack_of(frame)
                if stack:
                    self.folded[stack] = self.folded.get(stack, 0) + 1
            self._stop.wait(self.interval)

    def start(self) -> "SamplingProfiler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dbtpu-perf-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- output
    def folded_lines(self) -> List[str]:
        """`a;b;c <count>` lines (flamegraph.pl collapsed format)."""
        out = []
        for stack, n in sorted(self.folded.items(),
                               key=lambda kv: -kv[1]):
            out.append(";".join(stack) + f" {n}")
        return out


# ---------------------------------------------------------------- rendering

class _Node:
    __slots__ = ("name", "total", "children")

    def __init__(self, name: str):
        self.name = name
        self.total = 0
        self.children: Dict[str, _Node] = {}


def _build_tree(folded: Dict[Tuple[str, ...], int]) -> _Node:
    root = _Node("all")
    for stack, n in folded.items():
        root.total += n
        node = root
        for frame in stack:
            child = node.children.get(frame)
            if child is None:
                child = node.children[frame] = _Node(frame)
            child.total += n
            node = child
    return root


_PALETTE = ["#e4593b", "#e9743a", "#ed8f3a", "#f0a83e", "#f2bf49",
            "#d9803c", "#e06a3a", "#eb9a40"]


def render_flamegraph_svg(folded: Dict[Tuple[str, ...], int],
                          width: int = 1200, row_h: int = 17,
                          min_px: float = 0.3) -> str:
    """Standard flamegraph layout: x-extent = inclusive sample share,
    one row per stack depth, hover title = frame + counts."""
    root = _build_tree(folded)
    if root.total == 0:
        return ("<svg xmlns='http://www.w3.org/2000/svg' width='400' "
                "height='40'><text x='8' y='24'>no samples</text></svg>")

    def depth_of(node: _Node) -> int:
        return 1 + max((depth_of(c) for c in node.children.values()),
                       default=0)

    height = (depth_of(root) + 1) * row_h + 24
    px_per = width / root.total
    rects: List[str] = []

    def emit(node: _Node, x: float, depth: int) -> None:
        w = node.total * px_per
        if w < min_px:
            return
        y = height - (depth + 2) * row_h
        color = _PALETTE[hash(node.name) % len(_PALETTE)]
        label = _html.escape(node.name, quote=True)
        pct = 100.0 * node.total / root.total
        rects.append(
            f"<g><title>{label} — {node.total} samples "
            f"({pct:.1f}%)</title>"
            f"<rect x='{x:.2f}' y='{y}' width='{max(w - 0.5, 0.5):.2f}' "
            f"height='{row_h - 1}' fill='{color}' rx='1'/>"
            + (f"<text x='{x + 3:.2f}' y='{y + row_h - 5}' "
               f"font-size='11' font-family='monospace' fill='#241f1a'>"
               f"{label[: max(1, int(w / 6.8))]}</text>" if w > 28 else "")
            + "</g>")
        cx = x
        for child in sorted(node.children.values(), key=lambda c: c.name):
            emit(child, cx, depth + 1)
            cx += child.total * px_per

    emit(root, 0.0, 0)
    return (f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
            f"height='{height}' font-family='sans-serif'>"
            f"<rect width='100%' height='100%' fill='#faf6f2'/>"
            f"<text x='8' y='16' font-size='12'>flamegraph — "
            f"{root.total} samples</text>" + "".join(rects) + "</svg>")


def render_perf_html(node_sections: Iterable[Tuple[str, str]],
                     title: str = "databend_tpu EXPLAIN PERF") -> str:
    """One self-contained HTML page with one flamegraph per node —
    the reference nests per-node child pages the same way
    (query_perf.rs:86-120)."""
    sections = []
    for node_id, svg in node_sections:
        sections.append(
            f"<div class='flamegraph-container'>"
            f"<div class='flamegraph-header'>Node: "
            f"{_html.escape(node_id)}</div>"
            f"<div class='flamegraph-content'>{svg}</div></div>")
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title><style>"
            "body{font-family:sans-serif;background:#fff;margin:16px}"
            ".flamegraph-container{border:1px solid #ddd;margin:12px 0;"
            "border-radius:6px;overflow-x:auto}"
            ".flamegraph-header{padding:6px 10px;background:#f3ede7;"
            "font-weight:600}"
            ".flamegraph-content{padding:8px}"
            "</style></head><body>"
            f"<h2>{_html.escape(title)}</h2>"
            + "".join(sections) + "</body></html>")


def profile_call(fn, hz: int = DEFAULT_HZ):
    """Run ``fn()`` on a worker thread while sampling it; returns
    (result, profiler). Sampling a separate thread (not the caller)
    keeps the sampler's own frames out of the capture."""
    result: List = []
    error: List = []

    def work():
        try:
            result.append(fn())
        except BaseException as e:  # re-raised on the caller
            error.append(e)

    worker = threading.Thread(target=work, name="dbtpu-perf-target")
    worker.start()
    prof = SamplingProfiler(hz=hz, only_thread=worker.ident)
    prof.start()
    worker.join()
    prof.stop()
    if error:
        raise error[0]
    return result[0], prof
