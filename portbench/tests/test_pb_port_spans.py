"""The readers of the port's own spans (``port_spans.py``,
``metrics/knn_*_ms.py``) on a made-up record: ``portbench.batch`` spans
and ``dbt.*`` host events on two threads, some outside the window."""

import pytest

from portbench import harness

READERS = {"knn_params_ms": ("knn_params",),
           "knn_launch_ms": ("knn_launch",),
           "knn_fetch_wait_ms": ("knn_fetch",),
           "knn_result_ms": ("knn_take", "knn_block")}
BATCH_THREAD, OTHER = 7, 8


def read(name, record):
    return harness.load_module("metrics", name).read(record)


def made_up():
    """Two batches in a window of 0-100 us on thread 7: every span of the
    port once a batch, 1 us longer in the second. Thread 8 and the time
    before the window hold the same events, which no reader may count."""
    cpu = [["portbench.batch", 0.0, 40.0, None, BATCH_THREAD],
           ["portbench.batch", 50.0, 100.0, None, BATCH_THREAD]]
    for start, extra in ((0.0, 0.0), (50.0, 1.0)):
        t = start + 1.0
        for n, d in (("knn_batch", 0.0), ("knn_refresh", 1.0),
                     ("knn_params", 5.0), ("knn_upload", 1.0),
                     ("knn_launch", 2.0), ("knn_fetch", 20.0),
                     ("knn_take", 3.0), ("knn_block", 4.0)):
            if n == "knn_batch":
                cpu.append(["dbt.knn_batch", t, start + 39.0, None,
                            BATCH_THREAD])
                continue
            cpu.append(["dbt." + n, t, t + d + extra, None, BATCH_THREAD])
            cpu.append(["dbt." + n, t, t + 1000.0, None, OTHER])
            cpu.append(["dbt." + n, t - 500.0, t - 400.0, None,
                        BATCH_THREAD])
            t += d + extra
    cpu.append(["portbench.batch", -600.0, -300.0, None, BATCH_THREAD])
    cpu.sort(key=lambda r: r[1])
    return {"window_us": [0.0, 100.0], "batches": 2, "cpu": cpu,
            "device": [["gemm", 12.0, 30.0]], "spans": {}, "counters": {}}


WANT = {"knn_params_ms": (5 + 6) / 2 / 1e3,
        "knn_launch_ms": (2 + 3) / 2 / 1e3,
        "knn_fetch_wait_ms": (20 + 21) / 2 / 1e3,
        "knn_result_ms": (3 + 4 + 4 + 5) / 2 / 1e3}


@pytest.mark.parametrize("name", sorted(READERS))
def test_only_the_batch_thread_in_the_window_counts(name):
    assert read(name, made_up()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_divided_by_batches(name):
    rec = made_up()
    rec["batches"] = 4
    assert read(name, rec) == pytest.approx(WANT[name] / 2)


@pytest.mark.parametrize("name", sorted(READERS))
def test_silent_without_its_events(name):
    rec = made_up()
    mine = {"dbt." + n for n in READERS[name]}
    rec["cpu"] = [r for r in rec["cpu"] if r[0] not in mine]
    assert read(name, rec) is None
    # the parent's record: no span of the port at all
    rec["cpu"] = [r for r in rec["cpu"] if not r[0].startswith("dbt.")]
    assert read(name, rec) is None
    # only on another thread, or only before the window
    rec = made_up()
    rec["cpu"] = [r for r in rec["cpu"] if r[0] not in mine
                  or r[4] == OTHER or r[1] < 0]
    assert read(name, rec) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_silent_without_a_card_or_a_window(name):
    rec = made_up()
    rec["device"] = []            # the plain path on the CPU
    assert read(name, rec) is None
    for key in ("window_us", "batches", "cpu"):
        rec = made_up()
        del rec[key]
        assert read(name, rec) is None


def test_the_benchmark_lists_them_for_both_cells(bench):
    cells = [w["name"] for w in bench["workloads"]]
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(got) == set(READERS)
    for m in got.values():
        assert m["source"] == "program_span" and m["moves"] == "qps"
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["workloads"] == cells
