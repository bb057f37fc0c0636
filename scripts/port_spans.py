"""Read the port's own spans (``databend_tpu_torch/utils/tracing.py``) for a
benchmark cell.

    python3 scripts/port_spans.py record REC.json [REC.json ...]
    python3 scripts/port_spans.py setup --workload <cell> --seed <n> [--seconds S]
    python3 scripts/port_spans.py cost --workload <cell> --seed <n> [--rounds R]

``record`` reads the records that ``portbench/run.py --trace 1 --record
REC.json`` writes: for each, ms a batch of every ``dbt.*`` range on the
batches' thread in the window, the share of ``dbt.knn_batch`` its children
cover, the idle time by label (``devtrace.idle_gaps``), the part of the
idle time labelled ``batch:host`` that lies before the port's call in its
batch and after it (the benchmark's own Python: its feed, its reading of
the result), the device items a batch and whether any device row carries
a ``dbt.`` name.

``setup`` runs the cell once through the benchmark's harness on this
machine's card, untraced, with a span ring large enough to keep every span,
and prints the port's set-up spans: ``fuse_append`` and its steps (what
``ingest_s`` times from outside), ``knn_load_corpus`` and its steps (inside
``load_s``), each ``kernel_build`` and the ``kernel_builds`` /
``kernel_build_seconds`` counters, then the split of a window's batch by
``knn_batch``'s children (and, on the flash route, ``knn_launch``'s
``knn_flash_scan`` and ``knn_rerank``, with ``knn_flash_state``, the bf16
corpus built at the first approximate batch, and the ``knn_flash_batches``
/ ``knn_approx_exact`` counters) and the way each window batch's parameter
sets were taken in (the ``knn_params`` span's ``bulk``; the process's
``knn_params_bulk`` / ``knn_params_loop`` counters).

``cost`` builds the cell as the harness does and times the same batches
(the feed made beforehand) in one process with the port's serving spans
and with them replaced by no-ops, in turns, ``--rounds`` times over blocks
of 40 batches, with the profiler off and then on: the spans' cost a batch
without the noise between processes. Run from the root of a checkout;
prints one JSON object a line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNN_CHILDREN = ("knn_refresh", "knn_params", "knn_upload", "knn_launch",
                "knn_fetch", "knn_take", "knn_block")
FLASH_CHILDREN = ("knn_flash_scan", "knn_rerank")     # under knn_launch


def read_record(path: str) -> dict:
    from portbench import devtrace
    with open(path) as f:
        rec = json.load(f)
    window, batches = rec["window_us"], rec["batches"]
    cpu = devtrace.in_window(rec["cpu"], window)
    thread = next(r[4] for r in rec["cpu"] if r[0] == "portbench.batch")
    by = {}
    for name, s, e, _, th in cpu:
        if th == thread and name.startswith("dbt."):
            by[name] = by.get(name, 0.0) + (e - s)
    root = by.get("dbt.knn_batch", 0.0)
    kids = sum(by.get("dbt." + n, 0.0) for n in KNN_CHILDREN)
    return {"record": os.path.basename(path), "batches": batches,
            "ms_a_batch": {k: v / 1e3 / batches for k, v in
                           sorted(by.items(), key=lambda kv: -kv[1])},
            "children_share": kids / root if root else None,
            "idle_gaps_s": devtrace.idle_gaps(rec, top=20),
            "batch_host_s": _around_the_call(rec, thread),
            "device_items_a_batch":
                len(devtrace.in_window(rec["device"], window)) / batches,
            "device_rows_named_dbt":
                sum(r[0].startswith("dbt.") for r in rec["device"])}


def _around_the_call(rec, thread) -> dict:
    """Idle seconds labelled ``batch:host``, split by where they lie in
    their batch: ``before`` or ``after`` the port's ``dbt.knn_batch``, or
    in a batch without one (``no_call``)."""
    from portbench import devtrace
    lo, hi = rec["window_us"]
    idle, t = [], lo
    for s, e in devtrace.busy_intervals(rec):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    calls = sorted((r[1], r[2]) for r in rec["cpu"]
                   if r[0] == "dbt.knn_batch" and r[4] == thread)
    starts = [c[0] for c in calls]
    batches = sorted((r[1], r[2]) for r in rec["cpu"]
                     if r[0] == "portbench.batch")
    out = {"before": 0.0, "after": 0.0, "no_call": 0.0}
    for s0, s1, label in devtrace.host_segments(rec):
        if label != "batch:host":
            continue
        took = sum(max(0.0, min(s1, g1) - max(s0, g0)) for g0, g1 in idle)
        if not took:
            continue
        mid = (s0 + s1) / 2
        b = batches[bisect.bisect(batches, (mid, float("inf"))) - 1]
        i = bisect.bisect(starts, mid)
        if i < len(calls) and calls[i][0] <= b[1]:
            out["before"] += took / 1e6
        elif i and calls[i - 1][1] >= b[0]:
            out["after"] += took / 1e6
        else:
            out["no_call"] += took / 1e6
    return out


def _tree(spans, root_name: str) -> dict:
    """Seconds and count of each span under the spans named ``root_name``
    (by path below the root), the roots' own total first."""
    roots = [s for s in spans if s.name == root_name]
    out = {root_name: [sum(s.end - s.start for s in roots), len(roots)]}
    for s in spans:
        node, path = s, []
        while node is not None and node.name != root_name:
            path.append(node.name)
            node = node.parent
        if node is None or not path:
            continue
        key = "/".join(reversed(path))
        got = out.setdefault(key, [0.0, 0])
        got[0] += s.end - s.start
        got[1] += 1
    return out


def setup(workload: str, seed: int, seconds: float, device=None,
          spec=None) -> list:
    """The lines ``setup`` prints; ``device`` and ``spec`` (the harness's
    cell at another size) let a rehearsal run it on the CPU."""
    import torch
    os.environ.setdefault("DATABEND_TORCH_DEVICE", "cuda")
    from portbench import harness
    from databend_tpu_torch.utils import metrics, tracing
    tracing.RECORDER = tracing.SpanRecorder(capacity=1 << 22)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    run = harness.run_cell(bench, workload, seed, seconds, False,
                           device or torch.device("cuda", 0),
                           time.perf_counter(), spec=spec)
    spans = tracing.RECORDER.snapshot()
    counters = metrics.METRICS.snapshot()
    batches = [s for s in spans if s.name == "knn_batch"]
    window = {id(s) for s in batches[-run["batches"]:]}
    split = {n: 0.0 for n in ("knn_batch",) + KNN_CHILDREN}
    ways = {"bulk": 0, "loop": 0}
    for s in spans:
        if id(s) in window:
            split["knn_batch"] += s.end - s.start
        elif id(s.parent) in window and s.name in split:
            split[s.name] += s.end - s.start
            if "bulk" in s.attrs:
                ways["bulk" if s.attrs["bulk"] else "loop"] += 1
        elif s.name in FLASH_CHILDREN and s.parent is not None \
                and id(s.parent.parent) in window:
            split[s.name] = split.get(s.name, 0.0) + s.end - s.start
    return [
        {"workload": workload, "seed": seed, "correct": run["correct"],
         "benchmark_spans_s": run["spans"]},
        {"fuse_append_s": _tree(spans, "fuse_append")},
        {"knn_load_corpus_s": _tree(spans, "knn_load_corpus"),
         "knn_flash_state_s": _tree(spans, "knn_flash_state")},
        {"kernel_build": [[s.attrs.get("kernel"), s.attrs.get("seconds")]
                          for s in spans if s.name == "kernel_build"],
         "kernel_builds": counters.get("kernel_builds", 0),
         "kernel_build_seconds": counters.get("kernel_build_seconds", 0)},
        {"window_batches": len(window),
         "ms_a_batch": {k: v * 1e3 / max(len(window), 1)
                        for k, v in split.items()},
         "knn_params_in_window": ways,
         "knn_params_counters": {w: counters.get(f"knn_params_{w}", 0)
                                 for w in ("bulk", "loop")},
         "route_counters": {c: counters.get(c, 0) for c in
                            ("knn_flash_batches", "knn_approx_exact")}},
    ]


def cost(workload: str, seed: int, rounds: int, device=None, spec=None,
         block: int = 40) -> list:
    """The lines ``cost`` prints: the median ms a batch with the spans and
    without, the profiler off and on."""
    import contextlib
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.environ.setdefault("DATABEND_TORCH_DEVICE", "cuda")
    from portbench import harness
    import databend_tpu_torch as port
    from databend_tpu_torch.service import prepared
    device = device or torch.device("cuda", 0)
    spec = spec or harness.resolve(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    config, mix = spec["config"], spec["mix"]
    gen = harness.load_module("data", config["data"]["generator"])
    driver = harness.load_module("traffic", mix["driver"])
    data = gen.make(config, seed, device)
    ctx = port.SessionContext(f"memory://port-spans-cost-{os.getpid()}")
    gen.load(ctx, config, data)
    target = driver.prepare(ctx, mix)
    feed = driver.Feed(data, mix)
    sets = [feed.next()[1] for _ in range(block)]

    @contextlib.contextmanager
    def nothing(*args, **attrs):
        yield type("Quiet", (), {"attrs": {}})()

    real = {"span": prepared.span, "_knn_call": prepared._knn_call}
    quiet = {"span": nothing, "_knn_call": nothing}

    def timed(names) -> list:
        for key, fn in names.items():
            setattr(prepared, key, fn)
        out = []
        for params in sets:
            t0 = time.perf_counter()
            target.execute_batch_block(params, exact=mix["exact"])
            out.append(time.perf_counter() - t0)
        return out

    lines = []
    for traced in (False, True):
        got = {"spans": [], "none": []}
        for r in range(rounds + 1):
            order = [("spans", real), ("none", quiet)]
            if r % 2:
                order.reverse()
            ctx_ = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if traced else contextlib.nullcontext()
            with ctx_:
                for key, names in order:
                    t = timed(names)
                    if r:                       # round 0 warms up
                        got[key] += t
        med = {k: statistics.median(v) * 1e3 for k, v in got.items()}
        lines.append({"workload": workload, "profiler": traced,
                      "batches_a_side": len(got["spans"]),
                      "median_ms": med,
                      "spans_cost_us": (med["spans"] - med["none"]) * 1e3})
    for key, fn in real.items():
        setattr(prepared, key, fn)
    ctx.close()
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("record")
    r.add_argument("paths", nargs="+")
    s = sub.add_parser("setup")
    s.add_argument("--workload", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--seconds", type=float, default=4.0)
    c = sub.add_parser("cost")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--rounds", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.mode == "record":
        lines = [read_record(path) for path in args.paths]
    elif args.mode == "setup":
        lines = setup(args.workload, args.seed, args.seconds)
    else:
        lines = cost(args.workload, args.seed, args.rounds)
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
