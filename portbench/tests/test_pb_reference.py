"""The reference's tie rule and its comparison, against brute force."""

import numpy as np
import pytest
import torch

from portbench.reference import knn


def brute(x, q, k, descending_ties=False):
    """Exact squared distances in float64, sorted by (distance, id) with
    np.lexsort: the rule the reference has to keep."""
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    ids = np.arange(x.shape[0])
    key = -ids if descending_ties else ids
    order = np.stack([np.lexsort((key, row)) for row in d])[:, :k]
    return order, np.take_along_axis(d, order, 1)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("k", [1, 10, 33])
def test_tie_rule_on_tied_integer_rows(descending, k):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 3, size=(700, 6)).astype(np.float32)   # ties everywhere
    q = rng.integers(0, 3, size=(40, 6)).astype(np.float32)
    want_ids, want_d = brute(x, q, k, descending)
    got_ids, got_d = knn.Exact(x, torch.device("cpu")).top_k(q, k, descending)
    assert np.array_equal(got_ids, want_ids)
    assert np.array_equal(got_d, want_d)
    # every query has ties at rank k: the rule decides the answer
    full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    assert (np.sort(full, 1)[:, k - 1] == np.sort(full, 1)[:, k]).mean() > 0.5


def test_tie_rule_top_k_block_order():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, 2.0]])
    ids, v = knn.tie_rule_top_k(d, 4)
    assert ids.tolist() == [[3, 1, 2, 4]] and v.tolist() == [[0.0, 1.0, 1.0, 1.0]]
    ids, _ = knn.tie_rule_top_k(d, 4, descending_ties=True)
    assert ids.tolist() == [[3, 4, 2, 1]]


def served(ids, d):
    b, k = ids.shape
    return {"pool": np.arange(b), "query_index": np.repeat(np.arange(b), k),
            "id": ids.reshape(-1), "d": d.reshape(-1)}


def test_well_formed_marks_each_fault():
    ids = np.tile(np.arange(10), (4, 1))
    d = np.ones((4, 10), np.float32)
    ok, got, _, stray = knn.well_formed(served(ids, d), 10, 100)
    assert ok.all() and stray == 0 and np.array_equal(got, ids)
    bad = ids.copy()
    bad[0, 3] = bad[0, 4]              # a row twice
    bad[1, 0] = 100                    # out of range
    dd = d.copy()
    dd[2, 5] = np.nan                  # not finite
    ok, *_ = knn.well_formed(served(bad, dd), 10, 100)
    assert ok.tolist() == [False, False, False, True]
    half = served(ids, d)
    half = {k: (v[:20] if k != "pool" else v) for k, v in half.items()}
    ok, *_ = knn.well_formed(half, 10, 100)
    assert ok.tolist() == [True, True, False, False]
    stray_rows = served(ids, d)
    stray_rows["query_index"] = stray_rows["query_index"].copy()
    stray_rows["query_index"][-1] = 9
    ok, _, _, stray = knn.well_formed(stray_rows, 10, 100)
    assert stray == 1 and ok.tolist() == [True, True, True, False]


def test_judge_reads_zero_on_the_truth_and_more_on_a_wrong_row():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=(2000, 16)).astype(np.float32)
    q = rng.integers(0, 256, size=(64, 16)).astype(np.float32)
    ids, d2 = brute(x, q, 10)
    d = np.sqrt(d2).astype(np.float32)
    cpu = torch.device("cpu")
    data, config = {"rows": x, "queries": q}, {"k": 10}
    nums, failed = knn.judge([served(ids, d)], data, config, cpu)
    assert nums == {"malformed": 0, "answered": 64, "id_mismatch_share": 0.0,
                    "rank_gap": 0.0, "dist_err": 0.0} and failed == 0
    wrong = ids.copy()
    wrong[5, 9] = next(i for i in range(2000) if i not in ids[5])
    nums, _ = knn.judge([served(wrong, d)], data, config, cpu)
    assert nums["id_mismatch_share"] == 1 / 640 and nums["rank_gap"] > 0
    assert nums["dist_err"] > 0
