"""``BENCHMARK.json`` and the files it names keep the benchmark's rules:
names, units, keys, limits of count and length, and a file for every
configuration, traffic mix and per-layer metric."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")
        if os.path.exists(os.path.join(ROOT, w)) and w not in ("python3",):
            assert any(w == p or w.startswith(p + "/") for p in bench["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(bench, group):
    entries = bench[group]
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}
    assert 1 <= len(entries) <= limits[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_groups(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "dim"
        assert os.path.exists(os.path.join(harness.PKG, "data",
                                           cfg["data"]["generator"] + ".py"))
        assert set(cfg["limits"]) and all(v >= 0 for v in cfg["limits"].values())
        assert any(c["name"] == w["config"] for w in bench["workloads"])


def test_cells(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        mix = harness.load_json(os.path.join(harness.PKG, "traffic",
                                             w["traffic"] + ".json"))
        for kind, key in (("traffic", "driver"), ("reference", "reference")):
            assert os.path.exists(os.path.join(harness.PKG, kind, mix[key] + ".py"))
        e2e = [m for m in bench["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(harness.applies(m, w["name"]) for m in bench["per_layer"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and harness.applies(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read) and mod.read({}) is None
        layers.setdefault(m["layer"], m["layer"])


def test_every_file_is_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
                assert all(NAME.match(part) for part in rel.split("/")), rel
