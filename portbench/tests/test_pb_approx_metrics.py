"""The approximate cell's per-layer readers (``flash_minima_roofline``,
``approx_rerank_roofline``, ``knn_rerank_ms``) and their bounds
(``approx_bounds.py``) on a recorded trace (three batches of a traced
``sift1m-ann.approx-b1024`` window on the card) and on made-up ones; each
stays silent where its route, its kernel or its spans are missing."""

import copy
import json
import os

import pytest

from portbench import approx_bounds, harness
from portbench.devtrace import in_window

DATA = os.path.join(os.path.dirname(__file__), "data")
RECORDED = os.path.join(DATA, "sift1m-ann.approx-b1024.record.json")
EXACT = os.path.join(DATA, "sift1m.exact-b1024.record.json")
KERNEL = "flash_group_minima_kernel"
READERS = ("flash_minima_roofline", "approx_rerank_roofline", "knn_rerank_ms")


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def recorded():
    return load(RECORDED)


def read(name, record):
    return harness.load_module("metrics", name).read(record)


def test_bounds_at_the_cells_shape(recorded):
    sh = approx_bounds.shapes(recorded)
    assert sh == {"b": 256, "chunks": 4, "n": 1_015_808, "d": 128,
                  "tile": 16384, "lanes": 128, "shortlist": 20, "k": 10}
    # q f32, the bf16 corpus, its f32 norms, the [62, 256, 128] f32 minima
    nbytes = 4 * 256 * 128 + 2 * 1_015_808 * 128 + 4 * 1_015_808 \
        + 4 * 62 * 256 * 128
    assert approx_bounds.flash_bound(256, 1_015_808, 128, 16384, 128) \
        == (pytest.approx(nbytes / 3.35e12), "bytes")
    assert nbytes / 3.35e12 == pytest.approx(0.0813e-3, rel=1e-3)
    # the minima, 256 x 20 x 128 f32 rows of 128, the [256, 10] answer
    nbytes = 4 * 62 * 256 * 128 + 4 * 256 * 20 * 128 * 128 + 12 * 256 * 10
    assert approx_bounds.rerank_bound(256, 1_015_808, 128, 16384, 128, 20,
                                      10) == (pytest.approx(nbytes / 3.35e12),
                                              "bytes")
    assert nbytes / 3.35e12 == pytest.approx(0.1026e-3, rel=1e-3)


def test_flash_minima_roofline(recorded):
    lo, hi = recorded["window_us"]
    times = [e - s for n, s, e in recorded["device"]
             if lo <= s <= hi and KERNEL in n]
    assert len(times) == 12
    least = approx_bounds.flash_bound(256, 1_015_808, 128, 16384, 128)[0]
    got = read("flash_minima_roofline", recorded)
    assert got == pytest.approx(100 * least / (sum(times) / 12 / 1e6))
    assert 20 < got < 100


def test_approx_rerank_roofline(recorded):
    lo, hi = recorded["window_us"]
    rest = [e - s for n, s, e in recorded["device"]
            if lo <= s <= hi and KERNEL not in n
            and not n.startswith(("Memcpy", "Memset"))]
    least = approx_bounds.rerank_bound(256, 1_015_808, 128, 16384, 128, 20,
                                       10)[0]
    got = read("approx_rerank_roofline", recorded)
    assert got == pytest.approx(100 * least / (sum(rest) / 12 / 1e6))
    assert 0 < got < 100


def test_knn_rerank_ms(recorded):
    lo, hi = recorded["window_us"]
    thread = next(r[4] for r in recorded["cpu"] if r[0] == "portbench.batch")
    took = [e - s for n, s, e, _, th in in_window(recorded["cpu"], [lo, hi])
            if n == "dbt.knn_rerank" and th == thread]
    assert len(took) == 12
    got = read("knn_rerank_ms", recorded)
    assert got == pytest.approx(sum(took) / 1e3 / 3) and got > 0
    # the scan's enqueue is not the re-rank's
    scan = copy.deepcopy(recorded)
    scan["cpu"] = [r for r in scan["cpu"] if r[0] != "dbt.knn_flash_scan"]
    assert read("knn_rerank_ms", scan) == got


def test_the_parents_record_reads_the_kernels_alone(recorded):
    """A port without the flash route's spans (the parent's): the span
    reader is silent, the device readers read the same."""
    parent = copy.deepcopy(recorded)
    parent["cpu"] = [r for r in parent["cpu"]
                     if r[0] not in ("dbt.knn_flash_scan", "dbt.knn_rerank")]
    assert read("knn_rerank_ms", parent) is None
    for name in READERS[:2]:
        assert read(name, parent) == read(name, recorded)


@pytest.mark.parametrize("name", READERS)
def test_silent_where_the_route_did_not_run(name, recorded):
    # the exact cell: no approximate configuration, kernel or span
    assert read(name, load(EXACT)) is None
    assert read(name, {}) is None
    no_kernel = copy.deepcopy(recorded)
    no_kernel["device"] = [r for r in no_kernel["device"] if KERNEL not in r[0]]
    no_config = copy.deepcopy(recorded)
    del no_config["config"]["approx"]
    if name != "knn_rerank_ms":
        assert read(name, no_kernel) is None
        assert read(name, no_config) is None
    no_device = dict(recorded, device=[])      # the CPU's plain path
    assert read(name, no_device) is None


def test_made_up_denominators():
    """Two chunks in a 100 us window: the flash kernel 10 and 14 us, the
    rest 20 + 30 us of kernels beside a copy and a memset."""
    config = {"rows": 3000, "dim": 24, "k": 2,
              "approx": {"tile": 1024, "lanes": 128, "shortlist_groups": 4,
                         "query_chunk": 8}}
    rec = {"window_us": [0.0, 100.0], "batches": 1,
           "config": config, "mix": {"batch": 16},
           "device": [["Memcpy HtoD (Pageable -> Device)", 0.0, 5.0],
                      ["flash_group_minima_kernel<true>", 6.0, 16.0],
                      ["gather", 17.0, 37.0],
                      ["flash_group_minima_kernel<true>", 40.0, 54.0],
                      ["Memset (Device)", 55.0, 56.0],
                      ["sort", 57.0, 87.0],
                      ["late", 101.0, 120.0]],
           "cpu": []}
    sh = approx_bounds.shapes(rec)
    assert sh == {"b": 8, "chunks": 2, "n": 3072, "d": 32, "tile": 1024,
                  "lanes": 128, "shortlist": 4, "k": 2}
    flash = approx_bounds.flash_bound(8, 3072, 32, 1024, 128)[0]
    rerank = approx_bounds.rerank_bound(8, 3072, 32, 1024, 128, 4, 2)[0]
    assert read("flash_minima_roofline", rec) \
        == pytest.approx(100 * flash / 12e-6)
    assert read("approx_rerank_roofline", rec) \
        == pytest.approx(100 * rerank / 25e-6)


def test_the_cells_line_reads_every_metric_it_lists(bench, recorded):
    """The recorded window reads each per-layer metric the benchmark lists
    for the cell: the host spans, launches and idle share that the exact
    cells read too, and the three of the flash route; not the two rooflines
    of kernels the route does not run."""
    cell = "sift1m-ann.approx-b1024"
    listed = {m["name"] for m in bench["per_layer"]
              if harness.applies(m, cell)}
    assert set(READERS) <= listed
    assert not listed & {"distance_gemm_roofline", "exact_select_roofline"}
    line = harness.metrics_line(bench, cell, {"record": recorded}, True)
    assert set(line) == listed
    assert line["launches_per_batch"]["value"] == 182
    assert line["knn_rerank_ms"]["value"] < line["knn_launch_ms"]["value"]
