"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Top-level names are compared whole:
``databend_tpu_torch`` passes, ``databend_tpu`` does not."""

import ast
import os
import subprocess
import sys

from portbench import harness


def test_top_level_names_compare_whole():
    assert harness.foreign_modules(["databend_tpu_torch", "databend_tpu_torch.ops",
                                    "jax_like", "flaxen.x", "numpy"]) == []
    assert harness.foreign_modules(["databend_tpu", "databend_tpu.ops"]) \
        == ["databend_tpu"]
    assert harness.foreign_modules(["jax", "jaxlib.xla", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(harness.PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_names_them():
    for path in sources():
        tops = {m.split(".")[0] for m in imported(path)}
        assert not tops & set(harness.FOREIGN), path
    for path in sources("reference"):
        tops = {m.split(".")[0] for m in imported(path)}
        assert "databend_tpu_torch" not in tops, path


BLOCKED_RUN = r"""
import os, sys, time
sys.path.insert(0, {root!r})
BLOCK = {blocked!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Blocker())
os.environ["DATABEND_TORCH_DEVICE"] = "cpu"
import torch
from portbench import harness, control
bench = harness.load_json(os.path.join({root!r}, "BENCHMARK.json"))
for name in ("sift1m.exact-b1024", "gist1m.exact-b1024"):
    spec = harness.resolve(bench, name)
    spec["config"] = dict(spec["config"], rows=3000, queries=600)
    spec["mix"] = dict(spec["mix"], batch=256)
    out = harness.run_cell(bench, name, 3, 0.3, name.startswith("sift"),
                           torch.device("cpu"), time.perf_counter(), spec=spec)
    harness.metrics_line(bench, name, out, name.startswith("sift"))
    control.read(bench, name, "tf32", 3, 0.3, torch.device("cpu"), spec=spec)
print("FOREIGN", harness.foreign_modules())
"""


def test_a_run_loads_none_of_them():
    code = BLOCKED_RUN.format(root=harness.ROOT, blocked=list(harness.FOREIGN))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "FOREIGN []"
