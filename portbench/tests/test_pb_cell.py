"""A whole cell driven on the CPU through the harness's internals at a
tiny size, and ``run.py``'s refusals."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness

CELLS = ["sift1m.exact-b1024", "gist1m.exact-b1024"]
RUN = os.path.join(harness.PKG, "run.py")
# The limits are the card's. The CPU's plain path rounds otherwise: its
# vectorised sqrt is within one ulp, not correctly rounded (a distance no
# larger than the k-th: 2**-23 of it), and its f32 product sums in another
# order (at 960-d; the TF32 control reads 1.4e-3 there). Everything else
# holds as on the card.
CPU_ROUNDING = {"dist_err": 2.0 ** -23, "rank_gap": 1e-4}


def within(checks) -> bool:
    return all(c["value"] <= max(c["limit"], CPU_ROUNDING.get(n, 0))
               for n, c in checks.items())


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct_on_the_cpu(bench, tiny, name):
    t0 = time.perf_counter()
    out = harness.run_cell(bench, name, 2**31 + 17, 1.0, False,
                           torch.device("cpu"), t0, spec=tiny(name))
    assert within(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 512
    assert out["numbers"]["answered"] == out["attempted"]
    line = harness.metrics_line(bench, name, out, False)
    assert set(line) == {"qps", "batch_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line.values())
    assert out["end_to_end"]["setup_s"] > out["spans"]["insert"]
    # the plain path launches no kernel: the route is only checked on a card
    assert all(r["launched"] == 0 for r in out["route"].values())


def test_traced_tiny_cell_reads_what_the_cpu_has(bench, tiny):
    name = CELLS[0]
    out = harness.run_cell(bench, name, 5, 1.0, True, torch.device("cpu"),
                           time.perf_counter(), spec=tiny(name))
    assert within(out["checks"]), out["checks"]
    rec = out["record"]
    assert rec["batches"] >= 1 and rec["window_us"][1] > rec["window_us"][0]
    assert any(r[0] == "aten::mm" and r[3] for r in rec["cpu"])
    line = harness.metrics_line(bench, name, out, True)
    # no device here: the device readers find nothing and stay silent
    assert set(line) == {"ingest_s", "load_s"}


class Opaque:
    """Data that the harness cannot look inside: no keys, no fields."""

    __slots__ = ("inner",)

    def __init__(self, inner):
        self.inner = inner


def test_the_data_goes_on_unopened(bench, tiny, monkeypatch):
    """The generator's data reaches its ``load``, the driver's ``Feed`` and
    the reference as ``make`` returned it: a table or traffic of another
    shape is a new generator, driver or reference, not a harness edit."""
    real, seen = harness.load_module, {}

    def module(kind, name):
        mod = real(kind, name)
        ns = types.SimpleNamespace(**{k: getattr(mod, k) for k in dir(mod)})
        if kind == "data":
            ns.make = lambda config, seed, device: Opaque(
                mod.make(config, seed, device))
            ns.load = lambda ctx, config, data: (
                seen.setdefault("load", data), mod.load(ctx, config, data.inner))
        elif kind == "traffic":
            ns.Feed = lambda data, mix: (
                seen.setdefault("feed", data), mod.Feed(data.inner, mix))[1]
        elif kind == "reference":
            ns.judge = lambda batches, data, config, device: (
                seen.setdefault("judge", data),
                mod.judge(batches, data.inner, config, device))[1]
        return ns

    monkeypatch.setattr(harness, "load_module", module)
    name = CELLS[0]
    out = harness.run_cell(bench, name, 21, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), spec=tiny(name))
    assert within(out["checks"]), out["checks"]
    assert isinstance(seen["load"], Opaque)
    assert seen["load"] is seen["feed"] is seen["judge"]


def test_verdict_is_each_number_within_its_limit():
    checks, ok = harness.verdict({"a": 0, "b": 0.5, "c": 9}, {"a": 0, "b": 1})
    assert ok and checks == {"a": {"value": 0, "limit": 0},
                             "b": {"value": 0.5, "limit": 1}}
    _, ok = harness.verdict({"a": 1e-9, "b": 0.5}, {"a": 0, "b": 1})
    assert not ok
    _, ok = harness.verdict({"a": float("nan")}, {"a": 1})
    assert not ok


def test_same_seed_same_inputs(bench, tiny):
    spec = tiny(CELLS[1])
    cfg = spec["config"]
    gen = harness.load_module("data", cfg["data"]["generator"])
    small = dict(cfg, rows=500, queries=50)
    a = gen.make(small, 2**31 + 3, torch.device("cpu"))
    b = gen.make(small, 2**31 + 3, torch.device("cpu"))
    c = gen.make(small, 2**31 + 4, torch.device("cpu"))
    assert a["rows"].shape == (500, cfg["dim"]) and a["queries"].shape == (50, cfg["dim"])
    assert all(np.array_equal(a[k], b[k]) for k in ("rows", "queries"))
    assert not np.array_equal(a["rows"], c["rows"])
    assert a["rows"].min() >= cfg["data"]["clip_low"]
    assert a["rows"].max() <= cfg["data"]["clip_high"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.card
def test_run_refuses_without_the_port(card, tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(card, tmp_path, trace):
    record = tmp_path / "record.json"
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", CELLS[0], "--seed", "2",
         "--seconds", "2", "--trace", str(trace), "--record", str(record)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    names = bench["per_layer"] if trace else bench["end_to_end"]
    assert set(out["metrics"]) == {m["name"] for m in names}
    if trace:
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
        rec = json.loads(record.read_text())
        assert harness.metrics_line(bench, CELLS[0], {"record": rec}, True) \
            == out["metrics"]
    else:
        assert not record.exists()
