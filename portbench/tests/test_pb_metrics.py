"""Each per-layer reader on a recorded trace (three batches of a traced
``sift1m.exact-b1024`` window on the card) and on made-up ones."""

import json
import os

import pytest

from portbench import devtrace, harness, peaks

RECORDED = os.path.join(os.path.dirname(__file__), "data",
                        "sift1m.exact-b1024.record.json")


@pytest.fixture
def recorded():
    with open(RECORDED) as f:
        return json.load(f)


def read(name, record):
    return harness.load_module("metrics", name).read(record)


def test_launches_per_batch(recorded):
    lo, hi = recorded["window_us"]
    n = sum(1 for _, s, _ in recorded["device"] if lo <= s <= hi)
    assert read("launches_per_batch", recorded) == n / 3
    assert 25 <= n / 3 <= 45


def test_set_up_spans(recorded):
    assert read("ingest_s", recorded) == recorded["spans"]["insert"]
    assert read("load_s", recorded) == pytest.approx(
        recorded["spans"]["prepare"] + recorded["spans"]["load"])


def test_distance_gemm_roofline(recorded):
    lo, hi = recorded["window_us"]
    gemm = [e - s for n, s, e in recorded["device"]
            if lo <= s <= hi and "gemm" in n]
    mms = devtrace.products(recorded)
    assert mms == [(256, 128, 1_000_000)] * 12 and len(gemm) == 12
    # 2 * 256 * 1e6 * 128 FLOPs at 67 TFLOP/s: 0.978 ms a chunk
    least = 12 * 2 * 256 * 1e6 * 128 / 67e12
    got = read("distance_gemm_roofline", recorded)
    assert got == pytest.approx(100 * least / (sum(gemm) / 1e6))
    assert 30 < got < 100


def test_exact_select_roofline(recorded):
    lo, hi = recorded["window_us"]
    sel = [e - s for n, s, e in recorded["device"]
           if lo <= s <= hi and "block_kernel" in n]
    assert len(sel) == 12
    # one read of the [256, 1e6] f32 block, the norms, the [256, 10] out
    least = (4 * 256 * 1e6 + 12 * 256 * 10 + 4 * (256 + 1e6)) / 3.35e12
    assert peaks.exact_select_bound(256, 1_000_000, 10) == (
        pytest.approx(least), "bytes")
    got = read("exact_select_roofline", recorded)
    assert got == pytest.approx(100 * least / (sum(sel) / 12 / 1e6))
    assert 30 < got < 100


def test_device_idle_share(recorded):
    got = read("device_idle_share", recorded)
    lo, hi = recorded["window_us"]
    assert got == pytest.approx(100 * (1 - devtrace.busy_us(recorded) / (hi - lo)))
    assert 20 < got < 80


def made_up():
    """A 10 us window: two overlapping device items, one inside a span."""
    return {"window_us": [0.0, 10.0], "batches": 1,
            "device": [["k1", 1.0, 4.0], ["copy", 3.0, 5.0], ["k2", 8.0, 9.0],
                       ["late", 11.0, 12.0]],
            "cpu": [["portbench.batch", 0.0, 9.5, None, 7],
                    ["aten::mm", 0.5, 2.0, [[4, 3], [3, 8]], 7],
                    ["cudaMemcpyAsync", 5.0, 7.0, None, 7],
                    ["aten::view", 6.0, 6.0, None, 7],      # no duration
                    ["other_thread", 0.0, 10.0, None, 8]],
            "spans": {}, "counters": {}, "shape": {"k": 2}}


def test_union_counts_overlap_once():
    rec = made_up()
    assert devtrace.busy_intervals(rec) == [[1.0, 5.0], [8.0, 9.0]]
    assert devtrace.busy_us(rec) == 5.0
    assert read("device_idle_share", rec) == pytest.approx(50.0)
    assert read("launches_per_batch", rec) == 3


def test_idle_time_by_what_the_host_did():
    gaps = dict(devtrace.idle_gaps(made_up()))
    # idle: 0-1 (mm from 0.5), 5-8 (memcpy 5-7, then Python), 9-10
    assert gaps == pytest.approx({"batch:host": 0.5e-6 + 1e-6 + 0.5e-6,
                                  "batch:aten::mm": 0.5e-6,
                                  "batch:cudaMemcpyAsync": 2e-6,
                                  "between:host": 0.5e-6})
    ops = dict(devtrace.device_ops(made_up()))
    assert ops == pytest.approx({"k1": 3e-6, "copy": 2e-6, "k2": 1e-6})


def test_readers_stay_silent_without_their_items():
    rec = made_up()
    assert read("exact_select_roofline", rec) is None      # no block_kernel
    assert read("distance_gemm_roofline", rec) is None     # no gemm kernel
    assert read("ingest_s", rec) is None and read("load_s", rec) is None
