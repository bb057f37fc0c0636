"""The recall judge (``reference/knn_recall.py``), the plain approximate
route (``reference/approx_knn.py``) and the cell ``sift1m-ann.approx-b1024``
on the CPU: the judge reads 0 on sound answers, refuses each control of
``knn_recall_control.py`` at a size a test run holds, and lets a sound
stand-in through. On the card ``portbench/control.py`` reads the controls
at the cell's own size."""

import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference import approx_knn, knn_recall
from portbench.reference import knn_recall_control as controls

CPU = torch.device("cpu")
NAME = "sift1m-ann.approx-b1024"


def served(ids, d):
    b, k = ids.shape
    return {"pool": np.arange(b), "query_index": np.repeat(np.arange(b), k),
            "id": ids.reshape(-1), "d": d.reshape(-1)}


def brute(x, q):
    return ((q[:, None, :].astype(np.float64)
             - x[None].astype(np.float64)) ** 2).sum(-1)


def test_recall_counts_rows_within_the_kth():
    d2 = np.array([[1.0, 2.0, 3.0], [1.0, 5.0, 3.0]])
    assert knn_recall.recall(d2, np.array([3.0, 3.0])).tolist() \
        == [1.0, pytest.approx(2 / 3)]


def test_judge_on_the_truth_a_tie_and_a_row_beyond_the_kth():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, size=(3000, 8)).astype(np.float32)  # many ties
    q = rng.integers(0, 4, size=(64, 8)).astype(np.float32)
    full = brute(x, q)
    order = np.argsort(full, 1, kind="stable")
    cfg, data = {"k": 10}, {"rows": x, "queries": q}

    def judge(ids):
        d = np.sqrt(np.take_along_axis(full, ids, 1)).astype(np.float32)
        return knn_recall.judge([served(ids, d)], data, cfg, CPU)[0]

    nums = judge(order[:, :10])
    assert nums == {"malformed": 0, "answered": 64, "recall_shortfall": 0.0,
                    "dist_err": 0.0}
    # another row at the 10th distance: a tie broken the other way
    tied = order[:, :10].copy()
    j = next(j for j in range(64) if full[j, order[j, 10]] == full[j, order[j, 9]])
    tied[j, 9] = order[j, 10]
    assert judge(tied)["recall_shortfall"] == 0.0
    # a row beyond the 10th distance: one miss in 640
    far = order[:, :10].copy()
    far[j, 9] = order[j, -1]
    nums = judge(far)
    assert nums["recall_shortfall"] == pytest.approx(1 / 640)
    assert nums["dist_err"] == 0.0
    # a distance that is not the served row's
    d = np.sqrt(np.take_along_axis(full, order[:, :10], 1)).astype(np.float32)
    d[3, 4] *= 1.01
    nums = knn_recall.judge([served(order[:, :10], d)], data, cfg, CPU)[0]
    assert nums["recall_shortfall"] == 0.0 and nums["dist_err"] > 1e-3


def test_group_minima_are_exact_on_whole_numbers():
    """bf16 holds whole numbers up to 255 and f32 their products' sums:
    the route's group minima are float64's; on float rows they are not."""
    rng = np.random.default_rng(2)
    approx = {"tile": 512, "lanes": 128, "shortlist_groups": 20,
              "query_chunk": 256}
    for whole, equal in ((True, True), (False, False)):
        x = rng.uniform(0, 255, size=(1500, 128))
        q = rng.uniform(0, 255, size=(40, 128))
        if whole:
            x, q = np.round(x), np.round(q)
        x, q = x.astype(np.float32), q.astype(np.float32)
        route = approx_knn.Approx(x, approx, CPU)
        got = route.minima(torch.from_numpy(q)).numpy()
        s = (x.astype(np.float64) ** 2).sum(1)[None] \
            - 2 * q.astype(np.float64) @ x.astype(np.float64).T
        s = np.pad(s, ((0, 0), (0, route.padded - 1500)),
                   constant_values=np.inf)
        want = s.reshape(40, -1, 4, 128).min(2).reshape(40, -1)
        assert np.array_equal(got, want) == equal


def test_a_bf16_rerank_is_exact_on_whole_numbers():
    """Why the re-rank has no control of precision on this data."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, size=(2000, 128))
                         .astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 256, size=(50, 128))
                         .astype(np.float32))
    f32 = ((x[None] - q[:, None]) ** 2).sum(-1)
    xb, qb = x.bfloat16().float(), q.bfloat16().float()
    bf16 = (xb * xb).sum(1)[None] - 2 * qb @ xb.T + (qb * qb).sum(1)[:, None]
    assert torch.equal(xb, x) and torch.equal(bf16, f32)


def test_tiny_cell_is_correct_on_the_cpu(bench, tiny):
    spec = tiny(NAME)
    out = harness.run_cell(bench, NAME, 2**31 + 29, 1.0, False, CPU,
                           time.perf_counter(), spec=spec)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"malformed", "recall_shortfall", "dist_err"}
    n = out["numbers"]
    assert n["recall_shortfall"] == 0.0 and n["answered"] == out["attempted"]
    line = harness.metrics_line(bench, NAME, out, False)
    assert set(line) == {"qps", "batch_p95_ms", "setup_s"}


def test_traced_tiny_cell_reads_only_its_set_up_without_a_card(bench, tiny):
    out = harness.run_cell(bench, NAME, 6, 1.0, True, CPU,
                           time.perf_counter(), spec=tiny(NAME))
    assert out["correct"], out["checks"]
    # the plain path launches no kernel: the device readers stay silent,
    # and the port's spans are read only beside a card's items
    assert set(harness.metrics_line(bench, NAME, out, True)) \
        == {"ingest_s", "load_s"}


def big(tiny):
    """The cell at 40,000 rows, 3 tiles: enough clusters that a fault
    shows in recall."""
    return tiny(NAME, rows=40000, queries=1536, block=16384)


@pytest.mark.parametrize("name", sorted(controls.CONTROLS))
def test_each_control_is_refused(bench, tiny, name):
    got = control.read(bench, NAME, name, 7, 1.0, CPU, spec=big(tiny))
    assert got["refused"], got
    n, limits = got["numbers"], got["checks"]
    assert n["malformed"] == 0
    assert n["recall_shortfall"] > limits["recall_shortfall"]["limit"]
    # only the stale block serves distances that are not its rows'
    assert (n["dist_err"] > limits["dist_err"]["limit"]) \
        == (name == "stale_batch")


def test_a_sound_stand_in_is_not_refused(bench, tiny):
    spec = big(tiny)
    out = harness.run_cell(bench, NAME, 7, 1.0, False, CPU,
                           time.perf_counter(), spec=spec,
                           stand_in=controls._Route)
    assert out["correct"], out["checks"]
    assert out["numbers"]["recall_shortfall"] == 0.0
