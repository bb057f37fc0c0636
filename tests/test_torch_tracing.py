"""The port's spans from inside: a prepared KNN call, a Fuse append, the
corpus load at a call's refresh, a kernel build.

Each call that ``_KnnServer`` serves is one ``knn_batch`` span whose seven
children name the host's steps, all under one query id of the call's own
(the statement's under ``EXECUTE``). While ``torch.profiler`` records, each
span is also the range ``dbt.<name>`` on the calling thread; with the
profiler off no range is entered. The port runs on the CPU here
(``DATABEND_TORCH_DEVICE=cpu``), each test on its own ``memory://`` root.
"""

import itertools
import os
import re
import subprocess

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from databend_tpu_torch import backend
from databend_tpu_torch.errors import SemanticError
from databend_tpu_torch.expression import Column, DataBlock
from databend_tpu_torch.ops import _cuda
from databend_tpu_torch.service.session import SessionContext
from databend_tpu_torch.types import VectorType
from databend_tpu_torch.utils import tracing
from databend_tpu_torch.utils.metrics import METRICS

N, D, BLOCK = 2500, 8, 1024
CHILDREN = ["knn_refresh", "knn_params", "knn_upload", "knn_launch",
            "knn_fetch", "knn_take", "knn_block"]
LOAD = ["fuse_read_block"] * 3 + ["fuse_stack", "fuse_upload",
                                  "knn_projection", "knn_filters"]
KNN = ("SELECT id, l2_distance(emb, ?) AS d FROM t "
       "ORDER BY l2_distance(emb, ?) LIMIT 5")
FILTERED = ("SELECT id, l2_distance(emb, ?) AS d FROM t WHERE g < ? "
            "ORDER BY l2_distance(emb, ?) LIMIT 5")
_ROOTS = itertools.count()


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(autouse=True)
def _drain_span_rings():
    """Each test reads only its own spans, and leaves none to a later test
    file on this worker."""
    tracing.RECORDER.drain()
    yield
    tracing.RECORDER.drain()


def _rows():
    rng = np.random.default_rng(11)
    return rng.integers(0, 16, (N, D)).astype(np.float32)


def _block(rows):
    return DataBlock(["id", "g", "emb"], [
        Column.from_numpy(np.arange(len(rows), dtype=np.int64)),
        Column.from_numpy(np.arange(len(rows), dtype=np.int64) % 10),
        Column.from_numpy(rows, VectorType(D))])


@pytest.fixture
def table():
    """(a session over a table ``t`` of N rows in 3 blocks, its rows)."""
    ctx = SessionContext(f"memory://torch-tracing-{os.getpid()}-"
                         f"{next(_ROOTS)}")
    ctx.sql(f"CREATE TABLE t (id BIGINT, g BIGINT, emb VECTOR({D})) "
            f"ROW_PER_BLOCK='{BLOCK}'")
    ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2'")
    rows = _rows()
    ctx.insert_block("t", _block(rows))
    tracing.RECORDER.drain()
    yield ctx, rows
    ctx.close()


def _call(ctx, rows, kind, b=300):
    """One call of ``kind`` on ``b`` queries; returns (the answers as
    (ids, distances), the queries it asked)."""
    q = rows[:b] + 0.5
    if kind == "execute":
        res = [ctx.prepare(KNN).execute(q[0], q[0])]
        b = 1
    elif kind == "execute_batch":
        res = ctx.prepare(KNN).execute_batch([(v, v) for v in q])
    elif kind == "filtered":
        res = [ctx.prepare(FILTERED).execute_batch_block(
            [(v, 7, v) for v in q])]
    else:
        res = [ctx.prepare(KNN).execute_batch_block([(v, v) for v in q])]
    ids = np.concatenate([np.asarray(r.block.column("id").numpy())
                          for r in res])
    d = np.concatenate([np.asarray(r.block.column("d").numpy())
                        for r in res])
    return (ids, d), b


def _tree(spans):
    """The one ``knn_batch`` span and the names of its children in order."""
    roots = [s for s in spans if s.name == "knn_batch"]
    assert len(roots) == 1, [s.path() for s in spans]
    root = roots[0]
    return root, [s.name for s in spans if s.parent is root]


@pytest.mark.parametrize("kind", ["execute", "execute_batch",
                                  "execute_batch_block", "filtered"])
def test_each_served_call_is_one_knn_batch(table, kind):
    ctx, rows = table
    before = METRICS.snapshot()
    _, b = _call(ctx, rows, kind)
    spans = tracing.RECORDER.drain()
    root, kids = _tree(spans)
    assert kids == CHILDREN
    assert root.attrs == {"exact": True, "queries": b}
    launch = next(s for s in spans if s.name == "knn_launch")
    assert launch.attrs == {"chunks": -(-b // 256)}
    # a batch's parameter sets take the bulk path; one execute's, neither
    params = next(s for s in spans if s.name == "knn_params")
    bulk = kind != "execute"
    assert params.attrs == ({"bulk": True} if bulk else {})
    assert re.fullmatch(r"q\d+_\d+", root.query_id)
    assert {s.query_id for s in spans} == {root.query_id}
    for s in spans:
        assert root.start <= s.start <= s.end <= root.end
        assert s is root or s.path().startswith("knn_batch/")
        assert "." not in s.name
    after = METRICS.snapshot()
    assert after["knn_batches"] - before.get("knn_batches", 0) == 1
    assert after["knn_queries"] - before.get("knn_queries", 0) == b
    assert after.get("knn_params_bulk", 0) \
        - before.get("knn_params_bulk", 0) == bulk
    assert after.get("knn_params_loop", 0) \
        == before.get("knn_params_loop", 0)


def test_calls_get_their_own_ids_and_the_first_loads_the_corpus(table):
    ctx, rows = table
    p = ctx.prepare(KNN)
    sets = [(v, v) for v in rows[:300] + 0.5]
    p.execute_batch_block(sets)
    first = tracing.RECORDER.drain()
    p.execute_batch_block(sets)
    second = tracing.RECORDER.drain()
    (r1, k1), (r2, k2) = _tree(first), _tree(second)
    assert k1 == k2 == CHILDREN
    assert r1.query_id != r2.query_id
    assert {s.query_id for s in first} == {r1.query_id}
    assert {s.query_id for s in second} == {r2.query_id}
    load = [s for s in first if s.name == "knn_load_corpus"]
    assert len(load) == 1 and load[0].parent.name == "knn_refresh"
    assert sorted(s.name for s in first if s.parent is load[0]) == sorted(LOAD)
    assert all(s.attrs["rows"] > 0 for s in first
               if s.name == "fuse_read_block")
    assert not any(s.name in ("knn_load_corpus", "fuse_read_block")
                   for s in second)


def test_a_statement_id_is_kept(table):
    """Under a statement (``EXECUTE``) the call's spans carry its id."""
    ctx, rows = table
    token = tracing.set_query_id("q7_123_abcdef")
    try:
        _call(ctx, rows, "execute")
    finally:
        tracing.reset_query_id(token)
    spans = tracing.RECORDER.drain()
    assert {s.query_id for s in spans} == {"q7_123_abcdef"}
    assert tracing.current_query_id() is None


def test_spans_are_profiler_ranges_inside_the_caller(table):
    ctx, rows = table
    p = ctx.prepare(KNN)
    sets = [(v, v) for v in rows[:300] + 0.5]
    p.execute_batch_block(sets)           # the corpus is loaded
    tracing.RECORDER.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller.batch"):
            p.execute_batch_block(sets)
    spans = tracing.RECORDER.drain()
    events = list(prof.events())
    outer = next(e for e in events if e.name == "caller.batch")
    ranges = [e for e in events if e.name.startswith("dbt.")]
    assert sorted(e.name for e in ranges) == sorted(
        "dbt." + s.name for s in spans)
    assert {e.name for e in ranges} == {"dbt.knn_batch"} | {
        "dbt." + c for c in CHILDREN}
    root = next(e for e in ranges if e.name == "dbt.knn_batch")
    for e in ranges:
        assert e.thread == outer.thread
        assert outer.time_range.start <= e.time_range.start \
            <= e.time_range.end <= outer.time_range.end
        assert root.time_range.start <= e.time_range.start \
            <= e.time_range.end <= root.time_range.end
    # the device work a span encloses lies inside its range
    launch = next(e for e in ranges if e.name == "dbt.knn_launch")
    mms = [e for e in events if e.name == "aten::mm"]
    assert mms and all(launch.time_range.start <= e.time_range.start
                       and e.time_range.end <= launch.time_range.end
                       for e in mms)


class _Counting:
    """Stands in for ``record_function``; counts the ranges entered."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_range_is_entered_with_the_profiler_off(table, monkeypatch):
    ctx, rows = table
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(tracing, "record_function", _Counting)
    _call(ctx, rows, "execute_batch_block")
    n = len(tracing.RECORDER.drain())
    assert n > len(CHILDREN) and _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _call(ctx, rows, "execute_batch_block")
    assert _Counting.entered == len(tracing.RECORDER.drain())


@pytest.mark.parametrize("kind", ["execute_batch", "execute_batch_block",
                                  "filtered"])
def test_traced_answers_equal_untraced(table, kind):
    ctx, rows = table
    plain, _ = _call(ctx, rows, kind)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = _call(ctx, rows, kind)
    again, _ = _call(ctx, rows, kind)
    for got in (traced, again):
        assert np.array_equal(got[0], plain[0])
        assert np.array_equal(got[1], plain[1])


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_that_raises_still_records(profiled):
    with profile(activities=[ProfilerActivity.CPU]) if profiled \
            else _nothing() as prof:
        with pytest.raises(ValueError):
            with tracing.span("boom", size=3):
                raise ValueError("no")
    (s,) = tracing.RECORDER.drain()
    assert s.name == "boom" and s.attrs == {"size": 3, "error": "ValueError"}
    assert s.end >= s.start
    if profiled:
        assert [e.name for e in prof.events()
                if e.name.startswith("dbt.")] == ["dbt.boom"]


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_a_failed_call_records_its_error(table):
    ctx, rows = table
    p = ctx.prepare(KNN)
    wrong = np.zeros(D + 1, np.float32)
    with pytest.raises(SemanticError):
        p.execute_batch_block([(wrong, wrong)])
    spans = {s.name: s for s in tracing.RECORDER.drain()}
    assert spans["knn_batch"].attrs["error"] == "SemanticError"
    assert spans["knn_params"].attrs["error"] == "SemanticError"
    assert "knn_launch" not in spans


def test_an_insert_records_the_append_and_its_steps(table):
    ctx, rows = table
    ctx.insert_block("t", _block(rows))
    spans = tracing.RECORDER.drain()
    (root,) = [s for s in spans if s.name == "fuse_append"]
    assert root.attrs == {"rows": N}
    kids = [s for s in spans if s.parent is root]
    assert [s.name for s in kids] == (
        ["fuse_normalize", "fuse_cluster_sort"]
        + ["fuse_write_block", "fuse_block_indexes"] * 3 + ["fuse_commit"])
    assert [s.attrs["rows"] for s in kids if s.name == "fuse_write_block"] \
        == [1024, 1024, 452]
    assert all(root.start <= s.start <= s.end <= root.end for s in kids)


def test_the_ring_keeps_the_newest_spans():
    rec = tracing.SpanRecorder(capacity=3)
    made = [tracing.Span(f"s{i}", None, "") for i in range(5)]
    for s in made:
        rec.record(s)
    assert rec.snapshot() == made[2:]
    assert rec.drain() == made[2:]
    assert rec.snapshot() == [] and rec.drain() == []
    rec.record(made[0])
    assert rec.snapshot() == [made[0]]


def test_a_kernel_build_is_a_span_and_counts(tmp_path, monkeypatch):
    """``_cuda.build`` compiles once (a stand-in for nvcc here): the
    compile is a ``kernel_build`` span and moves both counters; a build
    that exists is neither."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "probe.cu").write_text("// probe\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(src))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")

    def nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info\n", "")

    monkeypatch.setattr(_cuda.subprocess, "run", nvcc)
    before = METRICS.snapshot()
    out = _cuda.build("probe")
    (s,) = tracing.RECORDER.drain()
    assert s.name == "kernel_build" and s.attrs["kernel"] == "probe"
    assert s.attrs["seconds"] == out["seconds"] >= 0.0
    after = METRICS.snapshot()
    assert after["kernel_builds"] - before.get("kernel_builds", 0) == 1
    assert after["kernel_build_seconds"] - before.get(
        "kernel_build_seconds", 0) == pytest.approx(out["seconds"])
    again = _cuda.build("probe")
    assert again["seconds"] == 0.0 and again["path"] == out["path"]
    assert tracing.RECORDER.drain() == []
    assert METRICS.snapshot()["kernel_builds"] == after["kernel_builds"]


def test_operators_read_them_in_the_system_tables(table):
    ctx, rows = table
    _call(ctx, rows, "execute_batch_block")
    got = ctx.sql("SELECT name, path, query_id FROM system.trace_spans "
                  "WHERE name LIKE 'knn%'").rows()
    assert {(n, p) for n, p, _ in got} >= {("knn_batch", "knn_batch")} | {
        (c, "knn_batch/" + c) for c in CHILDREN}
    assert len({q for _, _, q in got}) == 1
    counted = dict(ctx.sql("SELECT metric, value FROM system.metrics").rows())
    assert counted["knn_batches"] >= 1 and counted["knn_queries"] >= 300
    assert counted["knn_params_bulk"] >= 1
    # no dotted path: the per-operator profile stays the statements'
    ops = ctx.sql("SELECT operator FROM system.query_execution").rows()
    assert not any(op.startswith(("knn", "fuse")) for (op,) in ops)
