"""databend_tpu_torch is a package of its own.

* It runs from a copy of ``databend_tpu_torch/`` alone, in a directory
  without ``databend_tpu/``, with jax and databend_tpu blocked.
* Every port module that has a counterpart in ``databend_tpu/`` is a
  byte-identical copy of it, except the modules in ``PORT_OWN``: the device
  seams, the declining routes and the unported features. A reviewer of the
  port reads only those.
* No port source names the reference's directory or loads its files.
"""

import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_no_jax import run_slice_script  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "databend_tpu_torch")
REF = os.path.join(REPO, "databend_tpu")

PORT_OWN = {
    "__init__.py": "package docstring: the port's own host layers",
    "__main__.py": "usage, prog and version strings name databend_tpu_torch",
    "ops/distance.py": "torch distances",
    "ops/topk.py": "torch top-k",
    "ops/flash_topk.py": "wrapper of the CUDA group-min kernel",
    "ops/quantization.py": "SQ-u8 on torch: the exact f32 K-sliced int8 "
                           "product, tie-rule selections",
    "index/hnsw/__init__.py": "docstring: the torch build and search",
    "index/hnsw/build.py": "graph build on torch: kNN graph, prune, "
                           "dedupe + sort",
    "index/hnsw/search.py": "batched beam search on torch, Python-driven "
                            "loops",
    "index/kmeans.py": "Lloyd's iteration on torch",
    "index/inverted/device.py": "BM25 programs on torch, the impact scorer "
                                "through the CUDA kernel",
    "parallel/mesh.py": "a grid of torch devices with an owner a "
                        "position, sharded values as one tensor per own "
                        "position, collectives over shard lists that "
                        "cross processes over torch.distributed",
    "parallel/distributed.py": "sharded top-k / aggregate / k-means as "
                               "per-shard phases and collectives on torch",
    "parallel/exchange.py": "the exchanges as per-shard torch phases; host "
                            "decisions before the first upload",
    "parallel/multihost.py": "the registry's nodes join a torch.distributed "
                             "process group by a stated backend rule; the "
                             "mesh records each position's owner",
    "parallel/fragmenter.py": "the fused fragment's programs on torch; the "
                              "join fusion's host half returns its device "
                              "half, whose errors propagate",
    "pipeline/device_scan_agg.py": "resident columns and limb sums on torch, "
                                   "the grouped sums through the CUDA kernel; "
                                   "device errors propagate, the fused "
                                   "branch planned in the host half",
    "pipeline/device_join_agg.py": "the code gather and the LUT uploads on "
                                   "torch; each route's host half declines, "
                                   "the device half it returns propagates "
                                   "its errors",
    "pipeline/device_fusion.py": "HAVING / top-n on the grid on torch "
                                 "(stable sort passes for the multi-key "
                                 "sort, checked gathers); a float HAVING "
                                 "constant compares the finalized float64",
    "pipeline/executor.py": "_brute_force_scores on torch",
    "pipeline/window.py": "the key shuffle's errors propagate: it uploads "
                          "the rows",
    "expression/functions/vector_fns.py": "_rowwise device branch on torch",
    "storage/fuse/table.py": "vector columns and exact scans on torch",
    "storage/fuse/pruning/pruner.py":
        "_vector_prune_distributed on get_default_mesh; declines only "
        "before the first upload",
    "sql/binder.py": "_finalize_scan: enable_distributed from "
                     "get_default_mesh, no jax",
    "service/prepared.py": "serving programs on torch, flash approximate "
                           "mode, match() embeddings through backend",
    "service/system_tables.py": "build_options, clusters and credits "
                                "from torch",
    "service/merge.py": "ScanState from the port's binder",
    "meta/cluster.py": "local_node counts the port's devices and "
                       "registers their kind and card ids",
    "utils/perf.py": "stack paths compress at databend_tpu_torch/",
    "utils/tracing.py": "spans also enter torch.profiler ranges while it "
                        "records; deque ring",
    "settings.py": "the route gates' defaults and help texts measured on "
                   "the H100 (chip_smoke.py --gates): the scan-aggregate "
                   "route's mask and matmul caps 16, its pull screen 64 MB",
    "catalog/pushdown.py": "the vector gates' comments state the H100's "
                           "crossovers; the defaults equal the port's "
                           "settings",
    "index/inverted/reader.py": "DEVICE_MIN_DOCS, the twin of the served "
                                "match() gate, at the H100's 2,000 docs",
}


def _port_sources():
    for dirpath, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "build")]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, PORT).replace(os.sep, "/"), path


def test_port_runs_from_a_copy_without_the_reference(tmp_path):
    shutil.copytree(PORT, tmp_path / "databend_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    assert not (tmp_path / "databend_tpu").exists()
    run_slice_script(str(tmp_path), cwd=str(tmp_path))


def test_host_copies_match_reference():
    differ, same_own = [], []
    for rel, path in _port_sources():
        ref = os.path.join(REF, rel)
        if not os.path.exists(ref):
            continue
        with open(path, "rb") as a, open(ref, "rb") as b:
            same = a.read() == b.read()
        if rel in PORT_OWN and same:
            same_own.append(rel)
        elif rel not in PORT_OWN and not same:
            differ.append(rel)
    assert differ == [], "copies that differ from the reference"
    assert same_own == [], "PORT_OWN entries identical to the reference"
    port = dict(_port_sources())
    assert [r for r in PORT_OWN if r not in port] == []


def test_port_reads_no_reference_files():
    pat = re.compile(r"\b_reference\b|exec_reference|overlay_package"
                     r"|__path__\s*(\+?=|\.)|[\"']databend_tpu[\"'/]")
    hits = []
    for rel, path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{rel}:{i}: {line.strip()}")
    assert hits == []
