"""The check refuses its controls and the faults a serving cell can have,
at a size a test run holds. On the card ``portbench/control.py`` reads the
controls at the cells' own sizes."""

import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference import knn_control as controls

CPU = torch.device("cpu")


def test_tf32_product_is_refused_at_960d(bench, tiny):
    name = "gist1m.exact-b1024"
    got = control.read(bench, name, "tf32", 7, 0.5, CPU, spec=tiny(name))
    assert got["refused"], got
    # the product's rounding, not a structural fault, fails it
    assert got["numbers"]["malformed"] == 0
    assert got["numbers"]["rank_gap"] > 10 * 1e-5


def test_tf32_is_exact_on_whole_numbers(bench, tiny):
    """SIFT's rows are whole numbers up to 255: TF32 holds them and every
    product and sum exactly, so this control cannot fail there (the CPU's
    sqrt aside); the tie control stands for sift1m."""
    name = "sift1m.exact-b1024"
    got = control.read(bench, name, "tf32", 7, 0.5, CPU, spec=tiny(name))
    n = got["numbers"]
    assert n["malformed"] == 0 and n["id_mismatch_share"] == 0.0
    assert n["rank_gap"] == 0.0


def test_tie_order_is_refused_on_sift_rows(bench, tiny):
    name = "sift1m.exact-b1024"
    got = control.read(bench, name, "ties", 1, 2.0, CPU,
                       spec=tiny(name, rows=20000, queries=3000))
    assert got["batches"] * 512 >= 3000      # the whole pool was asked
    assert got["refused"] and got["numbers"]["id_mismatch_share"] > 0, got
    assert not got["checks"]["id_mismatch_share"]["value"] \
        <= got["checks"]["id_mismatch_share"]["limit"]


def test_round_to_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 255.0, 0.1])
    r = controls.round_to_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2.0 ** -10
    assert r[3] == 255.0 and abs(r[4] - 0.1) < 0.1 * 2.0 ** -11


class Stale:
    """Answers every batch after the first with the first one's block: a
    step that hands back its state unchanged."""

    def __init__(self, stmt):
        self.stmt, self.first = stmt, None

    def execute_batch_block(self, params, exact=True):
        res = self.stmt.execute_batch_block(params, exact=exact)
        self.first = self.first or res
        return self.first


class HalfBatch:
    """Answers only the first half of each batch."""

    def __init__(self, stmt):
        self.stmt = stmt

    def execute_batch_block(self, params, exact=True):
        return self.stmt.execute_batch_block(params[:len(params) // 2], exact=exact)


class Altered:
    """One query's last id of each batch replaced by another row's."""

    def __init__(self, stmt):
        self.stmt = stmt

    def execute_batch_block(self, params, exact=True):
        res = self.stmt.execute_batch_block(params, exact=exact)
        ids = res.block.column("id").numpy()
        ids[9] = (ids[9] + 1) % 6000 if ids[9] + 1 not in ids[:10] \
            else (ids[9] + 2) % 6000
        return res


@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered])
@pytest.mark.parametrize("name", ["sift1m.exact-b1024", "gist1m.exact-b1024"])
def test_faults_are_refused(bench, tiny, name, fault):
    out = harness.run_cell(bench, name, 13, 0.5, False, CPU,
                           time.perf_counter(), spec=tiny(name),
                           target_wrap=fault)
    assert not out["correct"], out["checks"]


def test_sound_statement_is_not_refused_by_the_wrapper_alone(bench, tiny):
    """The fault classes fail by their fault: a wrapper that passes every
    call through reads as the statement itself does."""
    class Through:
        def __init__(self, stmt):
            self.stmt = stmt

        def execute_batch_block(self, params, exact=True):
            return self.stmt.execute_batch_block(params, exact=exact)

    name = "sift1m.exact-b1024"
    out = harness.run_cell(bench, name, 13, 0.5, False, CPU,
                           time.perf_counter(), spec=tiny(name),
                           target_wrap=Through)
    n = out["numbers"]
    assert n["malformed"] == 0 and n["id_mismatch_share"] == 0.0
    assert n["rank_gap"] == 0.0 and np.isfinite(n["dist_err"])
