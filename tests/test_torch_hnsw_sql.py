"""HNSW through SQL: the same statements on both SessionContexts.

Vectors are small integers with 50 repeated rows, so the bf16 kNN graph and
every f32 distance of the build are exact and both packages write the same
graph files; queries are integer vectors too. Each case then asks for the
same rows from both contexts, ids equal and distances to rtol 1e-5 /
atol 1e-6 (sqrt of an exact integer on either side).

The cases: a graph on every block (``graphs='always'``) with plain and
compressed link files, under ``vector_search_mode`` hnsw / auto / exact;
an index without graphs under ``hnsw`` (the exact scan answers); and
``graphs='auto'`` with the row gate lowered so the insert builds graphs.
"""

import numpy as np
import pytest

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.catalog.pushdown import VectorIndexInfo as JaxInfo
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.storage.fuse import table as jtable
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.catalog.pushdown import VectorIndexInfo as TorchInfo
from databend_tpu_torch.index.hnsw import search as tsearch
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.storage.fuse import table as ttable
from databend_tpu_torch.utils import tracing as ttracing

N, D, RPB = 2500, 16, 1024


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    """Statements on either SessionContext record spans in their package's
    process-wide ring; empty both after the module, so that a later test
    file on this worker (tests/test_explain_profile.py) reads only its own
    spans."""
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _data():
    rng = np.random.default_rng(21)
    x = rng.integers(-4, 5, size=(N, D))
    x[300:350] = x[0:50]
    q = x[rng.integers(0, N, 6)] + rng.integers(-1, 2, size=(6, D))
    return x.astype(np.float32), q.astype(np.float32)


def _load(ctx, expr_mod, types_mod, name, x, options):
    ctx.sql(f"CREATE TABLE {name} (id BIGINT, emb VECTOR({D})) "
            f"ROW_PER_BLOCK='{RPB}'")
    ctx.sql(f"CREATE VECTOR INDEX {name}_v ON {name}(emb) distance='l2' "
            f"m='8' ef_construct='32' {options}")
    ctx.insert_block(name, expr_mod.DataBlock(
        ["id", "emb"],
        [expr_mod.Column.from_numpy(np.arange(len(x), dtype=np.int64)),
         expr_mod.Column.from_numpy(x, types_mod.VectorType(D))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    x, q = _data()
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load(ctx, e, ty, "gp", x, "graphs='always'")
        _load(ctx, e, ty, "gc", x, "graphs='always' links_format='compressed'")
        _load(ctx, e, ty, "ng", x, "graphs='never'")
    yield j, t, q
    j.close()
    t.close()


def _lit(v):
    return "[" + ",".join(f"{f:.1f}" for f in v) + "]"


def _knn(table, v):
    # ids alone: the vector rewrite (pruner -> per-block search) answers
    return (f"SELECT id FROM {table} "
            f"ORDER BY l2_distance(emb, {_lit(v)}) LIMIT 5")


def _same_rows(got, want):
    assert len(got) == 5 and got == want


def _graph_files(ctx, table):
    t = ctx.table(table)
    return [m.vector_indexes[f"{table}_v"]["graphs"]
            for seg in t.read_segments(t.read_snapshot()) for m in seg.blocks]


@pytest.mark.parametrize("table", ["gp", "gc"])
def test_graphs_always_writes_the_same_graphs(ctxs, table):
    j, t, _ = ctxs
    jt, tt = j.table(table), t.table(table)
    jm = [m for s in jt.read_segments(jt.read_snapshot()) for m in s.blocks]
    tm = [m for s in tt.read_segments(tt.read_snapshot()) for m in s.blocks]
    assert [m.row_count for m in tm] == [1024, 1024, 452]
    for a, b in zip(jm, tm):
        ga = jt.load_vector_graph(a, f"{table}_v", "l2")
        gb = tt.load_vector_graph(b, f"{table}_v", "l2")
        assert gb is not None and gb.num_levels == ga.num_levels
        for la, lb in zip(ga.links, gb.links):
            np.testing.assert_array_equal(lb, la)


def test_block_search_seam_matches_jax(ctxs):
    """``FuseTable.search_vector_index`` per block: ids equal, the SQL
    distances to rtol 1e-5 / atol 1e-6."""
    j, t, q = ctxs
    jt, tt = j.table("gp"), t.table("gp")
    jm = [m for s in jt.read_segments(jt.read_snapshot()) for m in s.blocks]
    tm = [m for s in tt.read_segments(tt.read_snapshot()) for m in s.blocks]
    for a, b in zip(jm, tm):
        want_d, want_i = jt.search_vector_index(
            a, JaxInfo("gp_v", "emb", "l2_distance", q[0].tolist()), q[:4], 5)
        got_d, got_i = tt.search_vector_index(
            b, TorchInfo("gp_v", "emb", "l2_distance", q[0].tolist()), q[:4], 5)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_allclose(got_d, np.asarray(want_d),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["hnsw", "auto", "exact"])
@pytest.mark.parametrize("table", ["gp", "gc"])
def test_knn_with_graphs_matches_jax(ctxs, table, mode, monkeypatch):
    j, t, q = ctxs
    calls = []
    real = tsearch._search_level0
    monkeypatch.setattr(tsearch, "_search_level0",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for ctx in (j, t):
        ctx.sql(f"SET vector_search_mode = '{mode}'")
        # auto takes the graph only for blocks over the exact-scan gate
        ctx.sql("SET vector_exact_scan_max_rows = 500")
    try:
        for v in q[:3]:
            _same_rows(t.sql(_knn(table, v)).rows(),
                       j.sql(_knn(table, v)).rows())
        plan = "\n".join(r[0] for r in t.sql("EXPLAIN " + _knn(table, q[0])).rows())
        assert f"vector_index={table}_v" in plan and "hnsw=on" in plan
    finally:
        for ctx in (j, t):
            ctx.sql("SET vector_search_mode = 'auto'")
            ctx.sql(f"SET vector_exact_scan_max_rows = {1 << 20}")
    # hnsw: every block; auto: the two blocks over 500 rows; exact: none
    assert len(calls) == {"hnsw": 9, "auto": 6, "exact": 0}[mode]


@pytest.mark.parametrize("mode", ["hnsw", "auto"])
def test_knn_without_a_graph_takes_the_exact_scan(ctxs, mode):
    """A table whose index has no graph answers under any mode: the search
    finds no graph and the exact scan takes the block."""
    j, t, q = ctxs
    assert all(g == {} for g in _graph_files(t, "ng"))
    for ctx in (j, t):
        ctx.sql(f"SET vector_search_mode = '{mode}'")
    try:
        for v in q[:3]:
            got = t.sql(_knn("ng", v)).rows()
            _same_rows(got, j.sql(_knn("ng", v)).rows())
            t.sql("SET vector_search_mode = 'exact'")
            assert got == t.sql(_knn("ng", v)).rows()
            t.sql(f"SET vector_search_mode = '{mode}'")
    finally:
        for ctx in (j, t):
            ctx.sql("SET vector_search_mode = 'auto'")


def test_graphs_auto_builds_over_the_row_gate(tmp_path, monkeypatch):
    """``graphs='auto'`` builds a graph for a block with more rows than
    ``GRAPH_BUILD_MIN_ROWS``: with the gate at 1,000 the two 1,024-row
    blocks get one and the 452-row block does not."""
    monkeypatch.setattr(jtable, "GRAPH_BUILD_MIN_ROWS", 1000)
    monkeypatch.setattr(ttable, "GRAPH_BUILD_MIN_ROWS", 1000)
    x, q = _data()
    j = JaxContext(str(tmp_path / "jax"))
    t = TorchContext(str(tmp_path / "torch"))
    try:
        for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
            _load(ctx, e, ty, "ga", x, "graphs='auto'")
            ctx.sql("SET vector_search_mode = 'hnsw'")
        assert [len(g) for g in _graph_files(t, "ga")] == [1, 1, 0]
        assert [len(g) for g in _graph_files(j, "ga")] == [1, 1, 0]
        for v in q[:3]:
            _same_rows(t.sql(_knn("ga", v)).rows(),
                       j.sql(_knn("ga", v)).rows())
    finally:
        j.close()
        t.close()
