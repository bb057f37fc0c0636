"""Distributed SQL through both SessionContexts, with
``enable_distributed_execution = 1``.

The JAX package runs on its 8 forced host devices, where
``get_default_mesh()`` is a mesh over them; the port (torch on the CPU,
asked for by name) under an installed mesh of 8 logical CPU shards. Each
statement's rows with the setting on must equal the port's own rows with it
off (integers equal, floats within rel 1e-5: the exchanges accumulate in
f32, the reference's contract) and the JAX package's rows with it on
(floats within rel 1e-6), and the exchange the statement is meant for must
be called in the port: the psum and shuffle grouped aggregates, the fused
aggregate + HAVING + top-n fragment in both variants and over a join, the
ordered top-n merge, the range-partition sort, the broadcast and shuffle
joins, the window's key shuffle. A literal KNN statement under
``enable_distributed_pruning`` takes the mesh-sharded vector prune in both
packages and returns the exact top-k.
"""

import tempfile

import numpy as np
import pytest
import torch

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch import parallel as tparallel
from databend_tpu_torch.parallel import exchange as tex
from databend_tpu_torch.parallel import fragmenter as tfr
from databend_tpu_torch.parallel import mesh as tmesh
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.storage.fuse.pruning import pruner as tpruner
from databend_tpu_torch.utils import tracing as ttracing

N = 20_000          # rows of m
HC = 70_000         # groups of hc: above the shuffle threshold (65,536)
D = 8


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


@pytest.fixture(scope="module", autouse=True)
def _mesh():
    old = tmesh.set_default_mesh(
        tmesh.make_mesh(8, devices=[torch.device("cpu")] * 8))
    yield
    tmesh.set_default_mesh(old)


def _load(ctx, e, ty):
    rng = np.random.default_rng(11)
    ctx.sql("CREATE TABLE m (k BIGINT, grp BIGINT, v DOUBLE, q BIGINT)")
    ctx.insert_block("m", e.DataBlock(
        ["k", "grp", "v", "q"],
        [e.Column.from_numpy(np.arange(N, dtype=np.int64)),
         e.Column.from_numpy(rng.integers(0, 40, N)),
         e.Column.from_numpy(rng.random(N)),
         e.Column.from_numpy(rng.integers(1, 50, N))]))
    ctx.sql("CREATE TABLE dim (grp BIGINT, tag BIGINT)")
    ctx.insert_block("dim", e.DataBlock(
        ["grp", "tag"], [e.Column.from_numpy(np.arange(40)),
                         e.Column.from_numpy(np.arange(40) % 7)]))
    ctx.sql("CREATE TABLE dup (grp BIGINT, w BIGINT)")
    ctx.insert_block("dup", e.DataBlock(
        ["grp", "w"], [e.Column.from_numpy(np.repeat(np.arange(20), 3)),
                       e.Column.from_numpy(np.arange(60))]))
    ctx.sql("CREATE TABLE hc (k2 BIGINT, x BIGINT)")
    ctx.insert_block("hc", e.DataBlock(
        ["k2", "x"], [e.Column.from_numpy(rng.permutation(HC + 5000) % HC),
                      e.Column.from_numpy(rng.integers(0, 1000, HC + 5000))]))
    ctx.sql(f"CREATE TABLE vt (id BIGINT, emb VECTOR({D})) "
            "ROW_PER_BLOCK='256'")
    ctx.insert_block("vt", e.DataBlock(
        ["id", "emb"],
        [e.Column.from_numpy(np.arange(2048, dtype=np.int64)),
         e.Column.from_numpy(_vectors(), ty.VectorType(D))]))
    # created after the writes: no block has a graph, the exact scan runs
    ctx.sql("CREATE VECTOR INDEX vti ON vt(emb) ASYNC distance='l2,cosine'")


def _vectors():
    return np.random.default_rng(12).standard_normal((2048, D)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def ctxs():
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    _load(j, jexpr, jtypes)
    _load(t, texpr, ttypes)
    yield j, t
    j.close()
    t.close()


# name -> (statement, the port functions it must call)
STATEMENTS = {
    "group_by_psum": (
        "SELECT grp, count(*), sum(q), sum(v), min(v), max(v), avg(v) "
        "FROM m GROUP BY grp ORDER BY grp", ["sharded_grouped_agg"]),
    "group_by_shuffle": (
        "SELECT k2, count(*), sum(x), max(x) FROM hc GROUP BY k2 ORDER BY k2",
        ["sharded_shuffle_grouped_agg"]),
    "agg_topn_psum": (
        "SELECT grp, sum(q) AS sq, count(*) AS c FROM m GROUP BY grp "
        "HAVING count(*) > 400 ORDER BY sq DESC LIMIT 5",
        ["sharded_grouped_agg_topn"]),
    "agg_topn_shuffle": (
        "SELECT k2, sum(x) AS sx FROM hc GROUP BY k2 HAVING count(*) > 1 "
        "ORDER BY sx DESC LIMIT 7", ["sharded_grouped_agg_topn"]),
    "agg_topn_join": (
        "SELECT tag, sum(q) AS s, count(*) AS c FROM m JOIN dim "
        "ON m.grp = dim.grp GROUP BY tag ORDER BY s DESC LIMIT 5",
        ["sharded_grouped_agg_topn"]),
    "order_by_limit": (
        "SELECT k, v FROM m ORDER BY v DESC LIMIT 100", ["sharded_topn"]),
    "order_by_full": (
        "SELECT k, grp, v FROM m WHERE k < 6000 ORDER BY grp, v",
        ["range_partition_sort"]),
    "broadcast_join": (
        "SELECT count(*), sum(tag) FROM m JOIN dim ON m.grp = dim.grp "
        "WHERE v < 0.5", ["broadcast_lookup_join"]),
    "shuffle_join": (
        "SELECT count(*), sum(w) FROM m JOIN dup ON m.grp = dup.grp",
        ["ShuffleJoin"]),
    "window": (
        "SELECT k, row_number() OVER (PARTITION BY grp ORDER BY v) AS rn "
        "FROM m ORDER BY k LIMIT 50", ["shuffle_by_key"]),
}


def _close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=rel), (g, w)
            else:
                assert a == b, (g, w)


def _spy(monkeypatch, names):
    calls = {n: 0 for n in names}
    for name in names:
        mod = tfr if name == "sharded_grouped_agg_topn" else tex
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_takes_its_exchange(ctxs, monkeypatch, name):
    j, t = ctxs
    sql, names = STATEMENTS[name]
    off = t.sql(sql).rows()
    assert off
    calls = _spy(monkeypatch, names)
    for ctx in (j, t):
        ctx.sql("SET enable_distributed_execution = 1")
    try:
        on = t.sql(sql).rows()
        ref = j.sql(sql).rows()
    finally:
        for ctx in (j, t):
            ctx.sql("SET enable_distributed_execution = 0")
    assert all(calls.values()), calls
    _close(on, off, 1e-5)
    _close(on, ref, 1e-6)


@pytest.mark.parametrize("mod, name, statement", [
    (tfr, "_agg_topn_psum", "agg_topn_join"),
    (tex, "shuffle_by_key", "window")], ids=["join_fusion", "window"])
def test_device_error_propagates(ctxs, monkeypatch, mod, name, statement):
    """From the upload on, an exchange's error reaches the caller: neither
    the fused join fragment nor the window's key shuffle gives way to the
    host (the reference's copies catch it there)."""
    _, t = ctxs

    def broken(*a, **k):
        raise RuntimeError("device half failed")

    monkeypatch.setattr(mod, name, broken)
    t.sql("SET enable_distributed_execution = 1")
    try:
        with pytest.raises(RuntimeError, match="device half failed"):
            t.sql(STATEMENTS[statement][0]).rows()
    finally:
        t.sql("SET enable_distributed_execution = 0")


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_distributed_vector_prune(ctxs, monkeypatch, fn):
    """Under ``enable_distributed_pruning`` (on by default) a literal KNN
    statement above ``vector_host_scan_max_rows`` takes the mesh-sharded
    prune in both packages: the port's returns blocks, its ids equal the
    JAX package's and a numpy truth."""
    from databend_tpu.storage.fuse.pruning import pruner as jpruner
    j, t = ctxs
    x = _vectors()
    q = x[7] + 0.001
    lit = "[" + ",".join(f"{v:.6f}" for v in q) + "]"
    sql = f"SELECT id FROM vt ORDER BY {fn}(emb, {lit}) LIMIT 5"
    hits = {"jax": 0, "torch": 0}
    topk_calls = []
    for mod, key in ((jpruner, "jax"), (tpruner, "torch")):
        real = mod.FusePruner._vector_prune_distributed

        def spy(self, *a, _real=real, _key=key):
            out = _real(self, *a)
            hits[_key] += out is not None
            return out

        monkeypatch.setattr(mod.FusePruner, "_vector_prune_distributed", spy)
    real_topk = tparallel.sharded_brute_force_topk
    monkeypatch.setattr(tparallel, "sharded_brute_force_topk",
                        lambda *a, **k: topk_calls.append(1)
                        or real_topk(*a, **k))
    for ctx in (j, t):
        ctx.sql("SET vector_host_scan_max_rows = 0")
    try:
        got, want = t.sql(sql).rows(), j.sql(sql).rows()
    finally:
        for ctx in (j, t):
            ctx.sql("SET vector_host_scan_max_rows = 65536")
    assert hits == {"jax": 1, "torch": 1} and topk_calls == [1]
    assert got == want
    if fn == "l2_distance":
        truth = np.argsort(np.linalg.norm(x - q, axis=1))[:5]
    else:
        xs = x / np.linalg.norm(x, axis=1, keepdims=True)
        truth = np.argsort(1 - xs @ (q / np.linalg.norm(q)))[:5]
    assert [r[0] for r in got] == truth.tolist()


def test_pruning_setting_off_keeps_the_prune_local(ctxs, monkeypatch):
    _, t = ctxs

    def boom(self, *a):
        raise AssertionError("the distributed prune must not run")

    monkeypatch.setattr(tpruner.FusePruner, "_vector_prune_distributed", boom)
    lit = "[" + ",".join(f"{v:.6f}" for v in _vectors()[3]) + "]"
    t.sql("SET enable_distributed_pruning = 0")
    t.sql("SET vector_host_scan_max_rows = 0")
    try:
        rows = t.sql(f"SELECT id FROM vt ORDER BY l2_distance(emb, {lit}) "
                     "LIMIT 1").rows()
    finally:
        t.sql("SET enable_distributed_pruning = 1")
        t.sql("SET vector_host_scan_max_rows = 65536")
    assert rows[0][0] == 3
