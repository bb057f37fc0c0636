"""One run of one cell: make the rows, load them through the port, warm the
cell's shapes, measure the window, check every answer against the plain
reference and print the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration (``configs/<config>.json``) names the data generator
(``data/<generator>.py``: it makes the cell's data from the seed and
builds the table from it), the table and the limits of the check; its
traffic mix (``traffic/<mix>.json``) names the driver
(``traffic/<driver>.py``), the statement, the route the port must take and
the reference that judges the answers (``reference/<name>.py``). The data
goes to the driver and to the reference as the generator made it: this
module never looks inside it. Each per-layer metric is read by
``metrics/<metric>.py``. A new cell, mix, configuration, table or metric is
a new file; none of these modules changes.
"""

from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import time

from . import devtrace
from .spans import Spans

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FOREIGN = ("jax", "jaxlib", "flax", "databend_tpu")
_RUNS = itertools.count()     # a process's runs each get their own root


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(PKG, kind, name + ".py")
    key = f"portbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration and traffic mix."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell,
            "config": load_json(os.path.join(ROOT, entry["file"])),
            "mix": load_json(os.path.join(PKG, "traffic",
                                          cell["traffic"] + ".json"))}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is ``jax``, ``jaxlib``, ``flax``
    or the JAX package ``databend_tpu`` (whole names: the port's
    ``databend_tpu_torch`` is none of them)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def launch_counters(mix: dict) -> dict:
    """The launch counter of each kernel the mix's route names
    (``module:function`` -> the function's ``launches``)."""
    out = {}
    for key in mix.get("launches_per_batch", {}):
        module, fn = key.split(":")
        out[key] = getattr(importlib.import_module(module), fn)
    return out


def free_port_state():
    """Drop the port's device caches (the stacked corpus) so the reference
    finds the card empty."""
    gc.collect()
    if "databend_tpu_torch" in sys.modules:
        from databend_tpu_torch.utils.cache import CacheManager
        CacheManager.instance().clear_all()
        gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def verdict(numbers: dict, limits: dict):
    """(each number compared beside its limit, whether every one is within
    it): the one comparison that decides ``correct``, for a run of the
    port and for a control alike."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, spec=None, target_wrap=None,
             stand_in=None) -> dict:
    """One run of cell ``name``; returns the result (its ``checks`` and
    ``route`` included). ``spec``: ``resolve``'s cell, configuration and
    mix (tests pass them at a small size). ``target_wrap`` (tests only)
    wraps the prepared statement the window drives; ``stand_in(data,
    config, device)`` (controls only) serves in the port's place, which is
    then not loaded.

    The data generator's ``make`` and ``load`` make the cell's data and its
    table; the traffic driver and the reference get that data as it is."""
    import torch
    spec = spec or resolve(bench, name)
    config, mix = spec["config"], spec["mix"]
    spans = Spans(annotate=traced)
    gen = load_module("data", config["data"]["generator"])
    with spans("generate"):
        data = gen.make(config, seed, device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    driver = load_module("traffic", mix["driver"])
    ctx = None
    if stand_in is None:
        import databend_tpu_torch as port
        counters = launch_counters(mix)
        # the table lives in the port's in-process object store: nothing
        # of it is written to disk
        ctx = port.SessionContext(
            f"memory://portbench-{os.getpid()}-{seed}-{next(_RUNS)}")
        with spans("insert"):
            gen.load(ctx, config, data)
        with spans("prepare"):
            target = driver.prepare(ctx, mix)
    else:
        counters = {}
        target = stand_in(data, config, device)
    if target_wrap is not None:
        target = target_wrap(target)
    feed = driver.Feed(data, mix)
    driver.warm(target, feed, mix, spans)
    setup_s = time.perf_counter() - t_start
    before = {k: f.launches for k, f in counters.items()}
    record = None
    if traced:
        batches, record = devtrace.capture(
            lambda: driver.window(target, feed, mix, seconds, spans))
    else:
        batches = driver.window(target, feed, mix, seconds, spans)
    if on_card:
        torch.cuda.synchronize()
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = driver.end_to_end(batches)
    e2e["setup_s"] = setup_s
    del target
    if ctx is not None:
        ctx.close()
    del ctx
    free_port_state()
    reference = load_module("reference", mix["reference"])
    with spans("check"):
        numbers, failed = reference.judge(batches, data, config, device)
    checks, correct = verdict(numbers, config["limits"])
    took = spans.seconds()
    out = {"correct": correct, "attempted": driver.attempted(batches),
           "failed": failed, "batches": len(batches),
           "end_to_end": e2e, "peak": peak, "spans": took,
           "route": {k: {"launched": v, "batches": len(batches),
                         "want": mix["launches_per_batch"][k] * len(batches)}
                     for k, v in launched.items()},
           "checks": checks, "numbers": numbers}
    if record is not None:
        record.update(batches=len(batches), spans=took,
                      counters={k.split(":")[1]: v for k, v in launched.items()},
                      config=config, mix=mix)
        out["record"] = record
    return out


def metrics_line(bench: dict, name: str, run: dict, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced) as ``{name: {"value", "unit"}}``; a reader that finds nothing
    leaves its metric out."""
    out = {}
    if not traced:
        for m in bench["end_to_end"]:
            if applies(m, name):
                out[m["name"]] = {"value": run["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if not applies(m, name):
            continue
        value = load_module("metrics", m["name"]).read(run["record"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(args, t_start: float) -> int:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = resolve(bench, args.workload)
    cell = spec["cell"]
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark never runs on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_start, spec=spec)
    wrong = {k: r for k, r in run["route"].items() if r["launched"] != r["want"]}
    for key, r in run["route"].items():
        print(f"portbench: route {key}: {r['launched']} launches over "
              f"{r['batches']} batches, want {r['want']}", file=sys.stderr)
    if wrong:
        print(f"portbench: the window did not take the cell's route: {wrong}",
              file=sys.stderr)
        return 3
    result = {"correct": run["correct"], "attempted": run["attempted"],
              "failed": run["failed"],
              "metrics": metrics_line(bench, args.workload, run,
                                      bool(args.trace)),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": cell["chips"],
                         "memory_peak_bytes": int(run["peak"]),
                         "power_limit": power_limit()}}
    if args.trace:
        rec = run["record"]
        result["device"]["busy_s"] = devtrace.busy_us(rec) / 1e6
        result["device"]["window_s"] = (rec["window_us"][1]
                                        - rec["window_us"][0]) / 1e6
        result["breakdown"] = {"device_ops": devtrace.device_ops(rec),
                               "idle_gaps": devtrace.idle_gaps(rec)}
        if args.record:
            with open(args.record, "w") as f:
                json.dump(rec, f)
    result["checks"] = run["checks"]
    print(f"portbench: spans {json.dumps(run['spans'])}; numbers "
          f"{json.dumps(run['numbers'])}", file=sys.stderr)
    found = foreign_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 4
    for key, c in run["checks"].items():
        print(f"portbench: check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
