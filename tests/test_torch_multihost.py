"""A mesh that spans query processes: databend_tpu_torch.parallel.multihost
and the mesh's collectives across processes, against the JAX package.

Each scenario starts one pair of port worker processes (torch on the CPU,
asked for by name). They register in one meta store, join a gloo process
group through ``join_cluster_mesh`` with 2 logical CPU shards each (a
4-shard mesh) and write their results to an ``.npz`` file; a module-scoped
fixture hands those to the parametrised cases, so that each check counts.
Every subprocess has a ``communicate`` timeout and every process group a
timeout, so a hang fails the test.

1. Twin of ``tests/test_multihost_dcn.py``: each worker holds only its half
   of a 4,096 x 32 Gaussian corpus (``mesh.from_process_local``). The
   sharded top-k ids are equal on both ranks and to the exact truth and to
   the JAX package's on a 4-device CPU mesh; the partial aggregates and the
   k-means step are within rel 1e-6 of the JAX functions (counts equal);
   everything is bit-equal to the single-process 4-shard port mesh.
2. The exchanges across processes, bit-equal to the single-process 4-shard
   port mesh on both ranks.
3. Twin of ``tests/test_multihost_sql.py``: five statement kinds under
   ``enable_distributed_execution = 1``; rows equal pandas and the JAX
   package's on a 4-device mesh, and each exchange fired.
4. In-process: the registry's ``TimeoutError`` / ``ValueError``, the
   backend rule, one-process meshes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from databend_tpu.utils import tracing as jtracing

from databend_tpu_torch import backend
from databend_tpu_torch.meta.cluster import ClusterDiscovery, NodeInfo
from databend_tpu_torch.meta.kv import MetaStore
from databend_tpu_torch.parallel import mesh as tmesh
from databend_tpu_torch.parallel import multihost
from databend_tpu_torch.utils import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 240        # seconds a worker pair may take
GROUP_TIMEOUT = 90          # the process group's timeout in the workers


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


WORKER = r'''
import os, sys
scenario, port, root, out = sys.argv[1:5]
os.environ["DATABEND_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, os.environ["DBTPU_REPO"])
import numpy as np
import torch
torch.set_num_threads(2)

from databend_tpu_torch.meta.cluster import ClusterDiscovery
from databend_tpu_torch.meta.kv import MetaStore
from databend_tpu_torch.parallel import multihost
from databend_tpu_torch.parallel import mesh as pm

# register this query node; the topology comes from the registry
meta = MetaStore(os.path.join(root, "meta.db"))
node = ClusterDiscovery.local_node(address=f"localhost:{port}")
ClusterDiscovery(meta).register(node)
mesh, rank = multihost.join_cluster_mesh(
    meta, node.node_id, 2, timeout=float(os.environ["GROUP_TIMEOUT"]),
    local_device_count=2)
assert pm.mesh_spans_processes(mesh), mesh.owners
assert mesh.backend == "gloo" and mesh.shape == {"dp": 1, "shard": 4}
assert mesh.owners.tolist() == [[0, 0, 1, 1]], mesh.owners
one = pm.make_mesh(4, devices=[torch.device("cpu")] * 4)
P, SH, DP = pm.P, pm.SHARD_AXIS, pm.DP_AXIS
res = {}


def dcn():
    from databend_tpu_torch.parallel import distributed as dd
    n, d, k = 4096, 32, 5
    rng = np.random.default_rng(0)        # same seed everywhere
    xg = rng.standard_normal((n, d)).astype(np.float32)
    q = xg[[7, 99, 2048, 4000]] + 0.01
    half = xg[rank * n // 2:(rank + 1) * n // 2]
    spread = {"span": pm.from_process_local(mesh, P(SH, None), half),
              "one": pm.put_sharded(xg, one, P(SH, None))}
    # this process uploaded only its own blocks
    blocks = [b for b in spread["span"].shards() if not pm.is_remote(b)]
    assert len(blocks) == 2 and all(
        np.array_equal(b.numpy(), half[m * 1024:(m + 1) * 1024])
        for m, b in enumerate(blocks))
    for tag, m in (("span", mesh), ("one", one)):
        x = spread[tag]
        qd = pm.put_sharded(q, m, P(DP, None))
        for bf16 in (False, True):
            dv, iv = dd.sharded_brute_force_topk(m, qd, x, k, "l2",
                                                 chunk_rows=1024, bf16=bf16)
            res[f"{tag}_topk{int(bf16)}_d"] = np.asarray(dv)
            res[f"{tag}_topk{int(bf16)}_i"] = np.asarray(iv)
        for op in ("sum", "max", "min", "count"):
            res[f"{tag}_agg_{op}"] = np.asarray(dd.sharded_partial_agg(m, x, op))
        cent = pm.put_sharded(xg[:8], m, P())
        new, cnt = dd.sharded_kmeans_step(m, x, cent)
        res[f"{tag}_kmeans_c"], res[f"{tag}_kmeans_n"] = (np.asarray(new),
                                                          np.asarray(cnt))
        res[f"{tag}_corpus"] = np.asarray(x)     # a gather across processes


def exchanges():
    from databend_tpu_torch.parallel import exchange as ex
    from databend_tpu_torch.parallel import fragmenter as fr
    rng = np.random.default_rng(1)
    g = rng.integers(-1, 50, 1003)
    v = np.column_stack([rng.standard_normal(1003), np.ones(1003),
                         rng.integers(-50, 50, 1003), rng.standard_normal(1003)])
    gw = rng.integers(-1, 3000, 5000)
    vw = np.column_stack([rng.standard_normal(5000), np.ones(5000),
                          rng.integers(-50, 50, 5000), rng.standard_normal(5000)])
    keys = rng.integers(-1, 90, 1003)
    build = rng.integers(-1, 70, 400)
    probe = rng.integers(-1, 90, 1003)
    ranks = rng.permutation(9000).astype(np.float32)
    topn_keys = rng.integers(0, 20, 1003).astype(np.float32)
    ubuild = rng.permutation(400)[:250]
    corpus = rng.standard_normal((1003, 3)).astype(np.float32)
    ops = ["sum", "count", "min", "max"]
    having = ("gt", ("leaf", ("col", 1, -1)), ("const", 2.0))
    for tag, m in (("span", mesh), ("one", one)):
        res[f"{tag}_grouped_agg"] = ex.sharded_grouped_agg(m, g, v, 50, ops)
        res[f"{tag}_shuffle_agg"] = ex.sharded_shuffle_grouped_agg(
            m, gw, vw, 3000, ops)
        for t, a in zip("ksv", ex.shuffle_by_key(m, keys, v[:, :2])):
            res[f"{tag}_shuffle_by_key_{t}"] = a
        for t, a in zip("lr", ex.ShuffleJoin(m, build).probe(probe)):
            res[f"{tag}_shuffle_join_{t}"] = a
        res[f"{tag}_range_sort"] = ex.range_partition_sort(m, ranks)
        for asc in (True, False):
            res[f"{tag}_topn_{int(asc)}"] = ex.sharded_topn(m, topn_keys, 17,
                                                            asc)
        res[f"{tag}_broadcast_join"] = ex.broadcast_lookup_join(m, probe,
                                                                ubuild)
        for route, thr in (("psum", 65536), ("shuffle", 10)):
            for hc in (None, having):
                t_gid, t_rows = fr.sharded_grouped_agg_topn(
                    m, gw, vw, 3000, ["sum", "sum", "min", "sum"],
                    ("col", 0, -1), 25, False, False, hc,
                    shuffle_threshold=thr)
                name = f"{tag}_agg_topn_{route}_{'having' if hc else 'plain'}"
                res[name + "_g"], res[name + "_r"] = t_gid, t_rows
        xs, nv = ex.shard_rows_padded(m, corpus, fill=-1.0)
        y, _ = ex.resize_width(m, xs, nv, 3, fill=-2.0)
        res[f"{tag}_resize"] = np.asarray(y)
        res[f"{tag}_rebalance"] = np.asarray(ex.rebalance(m, y, nv)[0])


def sql():
    import time
    import pandas as pd
    from databend_tpu_torch import parallel
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.parallel import fragmenter
    from databend_tpu_torch.service.session import SessionContext
    from databend_tpu_torch.types import VectorType
    from databend_tpu_torch.utils.metrics import METRICS
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        setattr(mod, name, counted)

    spy(fragmenter, "sharded_grouped_agg_topn")
    spy(parallel, "sharded_brute_force_topk")
    ctx = SessionContext(root)
    rng = np.random.default_rng(0)   # same data everywhere (shared storage)
    n = 4000
    k_col = rng.integers(0, 50, n)
    v_col = rng.integers(0, 1000, n)
    emb = rng.standard_normal((500, 8)).astype(np.float32)
    dup_k = rng.integers(0, 50, 120)
    dup_w = rng.integers(1, 10, 120)
    q = rng.standard_normal(8).astype(np.float32)
    flag = os.path.join(root, "ddl_done")
    if rank == 0:
        ctx.sql("CREATE TABLE t (k INT, v BIGINT)")
        ctx.insert_block("t", DataBlock(
            ["k", "v"], [Column.from_numpy(k_col.astype(np.int32)),
                         Column.from_numpy(v_col.astype(np.int64))]))
        ctx.sql("CREATE TABLE vt (id BIGINT, emb VECTOR(8))")
        ctx.sql("CREATE VECTOR INDEX vt_v ON vt(emb) ASYNC distance='l2'")
        ctx.insert_block("vt", DataBlock(
            ["id", "emb"], [Column.from_numpy(np.arange(500, dtype=np.int64)),
                            Column.from_numpy(emb, VectorType(8))]))
        ctx.sql("CREATE TABLE dup (k INT, w BIGINT)")
        ctx.insert_block("dup", DataBlock(
            ["k", "w"], [Column.from_numpy(dup_k.astype(np.int32)),
                         Column.from_numpy(dup_w.astype(np.int64))]))
        with open(flag, "w") as f:
            f.write("1")
    else:
        for _ in range(600):
            if os.path.exists(flag):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError("DDL barrier")
    ctx.sql("SET enable_distributed_execution = 1")
    ctx.sql("SET vector_host_scan_max_rows = 0")
    qlit = "[" + ",".join(f"{x:.6f}" for x in q) + "]"
    statements = {
        "psum_fragment": "SELECT k, sum(v) AS s, count(*) AS c FROM t "
                         "GROUP BY k HAVING sum(v) > 30000 ORDER BY s DESC "
                         "LIMIT 5",
        "knn": f"SELECT id FROM vt ORDER BY l2_distance(emb, {qlit}) LIMIT 5",
        "shuffle_join": "SELECT t.v, dup.w FROM t JOIN dup ON t.k = dup.k "
                        "WHERE t.v >= 990 ORDER BY t.v, dup.w",
        "range_sort": "SELECT v FROM t ORDER BY v",
        "window": "SELECT k, v, sum(v) OVER (PARTITION BY k) AS sv FROM t "
                  "ORDER BY k, v LIMIT 10",
    }
    counters = ("shuffle_join_queries", "distributed_fullsort_queries",
                "distributed_window_queries")
    for name, stmt in statements.items():
        calls.clear()
        before = METRICS.snapshot()
        rows = ctx.sql(stmt).rows()
        after = METRICS.snapshot()
        res[f"rows_{name}"] = np.asarray(rows, np.int64)
        fired = [after.get(c, 0) - before.get(c, 0) for c in counters]
        res[f"fired_{name}"] = np.asarray(
            fired + [calls.get("sharded_grouped_agg_topn", 0),
                     calls.get("sharded_brute_force_topk", 0)], np.int64)
    ctx.close()


{"dcn": dcn, "exchanges": exchanges, "sql": sql}[scenario]()
from databend_tpu_torch.utils.metrics import METRICS
res["collective_calls"] = np.asarray(METRICS.snapshot()["mesh_collectives"])
np.savez(os.path.join(out, f"{scenario}{rank}.npz"), **res)
multihost.leave_cluster_mesh()
print(f"rank{rank} OK", flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp, scenario):
    """Start two workers of ``scenario``; returns their results by rank."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    root = tmp / "data"
    root.mkdir()
    env = dict(os.environ, DBTPU_REPO=REPO, GROUP_TIMEOUT=str(GROUP_TIMEOUT))
    procs = [subprocess.Popen(
        [sys.executable, str(script), scenario, str(_free_port()), str(root),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for _ in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
    return [dict(np.load(tmp / f"{scenario}{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def dcn(tmp_path_factory):
    return _run_pair(tmp_path_factory.mktemp("dcn"), "dcn")


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    return _run_pair(tmp_path_factory.mktemp("exchanges"), "exchanges")


@pytest.fixture(scope="module")
def sql(tmp_path_factory):
    return _run_pair(tmp_path_factory.mktemp("sql"), "sql")


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ 1. the DCN twin

N, D, B, K = 4096, 32, 4, 5


def _dcn_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, x[[7, 99, 2048, 4000]] + 0.01


@pytest.fixture(scope="module")
def jax_dcn():
    """The JAX package's functions on a 4-device CPU mesh, same inputs."""
    from databend_tpu.parallel import distributed as jd
    from databend_tpu.parallel import mesh as jm
    x, q = _dcn_inputs()
    m = jm.make_mesh(4)
    xs = jm.put_sharded(x, m, jm.P(jm.SHARD_AXIS, None))
    qd = jm.put_sharded(q, m, jm.P(jm.DP_AXIS, None))
    out = {}
    dv, iv = jd.sharded_brute_force_topk(m, qd, xs, K, "l2", chunk_rows=1024)
    out["topk_d"], out["topk_i"] = np.asarray(dv), np.asarray(iv)
    for op in ("sum", "max", "min", "count"):
        out[f"agg_{op}"] = np.asarray(jd.sharded_partial_agg(m, xs, op))
    new, cnt = jd.sharded_kmeans_step(
        m, xs, jm.put_sharded(x[:8], m, jm.P()))
    out["kmeans_c"], out["kmeans_n"] = np.asarray(new), np.asarray(cnt)
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_dcn_topk_exact_on_every_rank(dcn, rank):
    x, q = _dcn_inputs()
    d = ((x[None, :, :] - q[:, None, :]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    assert np.array_equal(dcn[rank]["span_topk0_i"], truth)
    assert _same_bits(dcn[rank]["span_topk0_i"], dcn[1 - rank]["span_topk0_i"])
    # bf16 scores: every true neighbour found (well separated at this size)
    assert np.array_equal(np.sort(dcn[rank]["span_topk1_i"], 1),
                          np.sort(truth, 1))


@pytest.mark.parametrize("rank", [0, 1])
def test_dcn_topk_equals_jax(dcn, jax_dcn, rank):
    """Ids equal; the squared distances ``|x|^2 - 2 q.x + |q|^2`` within
    4 f32 ulp of ``|x|^2 + |q|^2`` (the two packages sum in other orders,
    and the nearest rows' distances cancel)."""
    x, q = _dcn_inputs()
    ids = dcn[rank]["span_topk0_i"]
    assert np.array_equal(ids, jax_dcn["topk_i"])
    terms = (x[ids] ** 2).sum(-1) + (q ** 2).sum(-1)[:, None]
    err = np.abs(dcn[rank]["span_topk0_d"].astype(np.float64) ** 2
                 - jax_dcn["topk_d"].astype(np.float64) ** 2)
    assert (err <= 4 * 2.0 ** -24 * terms).all(), err.max()


@pytest.mark.parametrize("what", ["agg_sum", "agg_max", "agg_min",
                                  "agg_count", "kmeans_c", "kmeans_n"])
def test_dcn_aggregates_equal_jax(dcn, jax_dcn, what):
    """Counts, minima and maxima equal; the centroids within rel 1e-6; the
    column sums within 1e-6 of the sum of their terms' magnitudes (f32
    sums of 4,096 Gaussian values in another order cancel to a fraction of
    that scale)."""
    want = jax_dcn[what]
    for r in range(2):
        got = dcn[r][f"span_{what}"]
        assert got.shape == want.shape
        if what in ("agg_count", "kmeans_n", "agg_max", "agg_min"):
            assert np.array_equal(got, want)
        elif what == "agg_sum":
            scale = np.abs(_dcn_inputs()[0]).sum(0)
            assert (np.abs(got - want) <= 1e-6 * scale).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("what", [
    "topk0_d", "topk0_i", "topk1_d", "topk1_i", "agg_sum", "agg_max",
    "agg_min", "agg_count", "kmeans_c", "kmeans_n", "corpus"])
def test_dcn_bit_equal_to_one_process(dcn, what):
    """Both ranks return the bits of the single-process 4-shard mesh (the
    psum's shard-order sum included) and of each other."""
    for r in range(2):
        assert _same_bits(dcn[r][f"span_{what}"], dcn[r][f"one_{what}"])
        assert _same_bits(dcn[r][f"span_{what}"], dcn[1 - r][f"span_{what}"])
    if what == "corpus":
        assert np.array_equal(dcn[0]["span_corpus"], _dcn_inputs()[0])


def test_dcn_collectives_crossed_processes(dcn):
    assert all(int(dcn[r]["collective_calls"]) > 0 for r in range(2))


# -------------------------------------------------------- 2. the exchanges


EXCHANGES = ["grouped_agg", "shuffle_agg", "shuffle_by_key_k",
             "shuffle_by_key_s", "shuffle_by_key_v", "shuffle_join_l",
             "shuffle_join_r", "range_sort", "topn_1", "topn_0",
             "broadcast_join", "agg_topn_psum_plain_g",
             "agg_topn_psum_plain_r", "agg_topn_psum_having_g",
             "agg_topn_psum_having_r", "agg_topn_shuffle_plain_g",
             "agg_topn_shuffle_plain_r", "agg_topn_shuffle_having_g",
             "agg_topn_shuffle_having_r", "resize", "rebalance"]


@pytest.mark.parametrize("what", EXCHANGES)
def test_exchange_across_processes(exchanges, what):
    for r in range(2):
        got = exchanges[r][f"span_{what}"]
        assert got.size > 0
        assert _same_bits(got, exchanges[r][f"one_{what}"])
        assert _same_bits(got, exchanges[1 - r][f"span_{what}"])


# ------------------------------------------------------------- 3. the SQL twin

STATEMENTS = ["psum_fragment", "knn", "shuffle_join", "range_sort", "window"]
# which entry of a worker's fired_* array must be positive
FIRED = {"shuffle_join": 0, "range_sort": 1, "window": 2,
         "psum_fragment": 3, "knn": 4}


def _sql_data():
    rng = np.random.default_rng(0)
    n = 4000
    k_col = rng.integers(0, 50, n)
    v_col = rng.integers(0, 1000, n)
    emb = rng.standard_normal((500, 8)).astype(np.float32)
    dup_k = rng.integers(0, 50, 120)
    dup_w = rng.integers(1, 10, 120)
    q = rng.standard_normal(8).astype(np.float32)
    return k_col, v_col, emb, dup_k, dup_w, q


def _pandas_rows(name):
    import pandas as pd
    k_col, v_col, emb, dup_k, dup_w, q = _sql_data()
    df = pd.DataFrame({"k": k_col, "v": v_col})
    if name == "psum_fragment":
        g = df.groupby("k").agg(s=("v", "sum"), c=("v", "size")).reset_index()
        g = g[g.s > 30000].sort_values("s", ascending=False).head(5)
        return [(int(r.k), int(r.s), int(r.c)) for r in g.itertuples()]
    if name == "knn":
        q = np.asarray([float(f"{x:.6f}") for x in q], np.float32)
        return [(int(i),) for i in np.argsort(
            np.linalg.norm(emb - q, axis=1))[:5]]
    if name == "shuffle_join":
        jd = df.merge(pd.DataFrame({"k": dup_k, "w": dup_w}), on="k")
        jd = jd[jd.v >= 990].sort_values(["v", "w"])
        return [(int(r.v), int(r.w)) for r in jd.itertuples()]
    if name == "range_sort":
        return [(int(v),) for v in sorted(v_col.tolist())]
    df["sv"] = df.groupby("k").v.transform("sum")
    df = df.sort_values(["k", "v"]).head(10)
    return [(int(r.k), int(r.v), int(r.sv)) for r in df.itertuples()]


@pytest.fixture(scope="module")
def jax_sql(tmp_path_factory):
    """The same statements through the JAX package's SessionContext with
    ``enable_distributed_execution = 1`` on a 4-device mesh."""
    from databend_tpu.expression import Column, DataBlock
    from databend_tpu.parallel import mesh as jm
    from databend_tpu.service.session import SessionContext
    from databend_tpu.types import VectorType
    k_col, v_col, emb, dup_k, dup_w, q = _sql_data()
    old = jm._DEFAULT_MESH
    jm._DEFAULT_MESH = jm.make_mesh(4)
    try:
        ctx = SessionContext(str(tmp_path_factory.mktemp("jax_sql")))
        ctx.sql("CREATE TABLE t (k INT, v BIGINT)")
        ctx.insert_block("t", DataBlock(
            ["k", "v"], [Column.from_numpy(k_col.astype(np.int32)),
                         Column.from_numpy(v_col.astype(np.int64))]))
        ctx.sql("CREATE TABLE vt (id BIGINT, emb VECTOR(8))")
        ctx.sql("CREATE VECTOR INDEX vt_v ON vt(emb) ASYNC distance='l2'")
        ctx.insert_block("vt", DataBlock(
            ["id", "emb"], [Column.from_numpy(np.arange(500, dtype=np.int64)),
                            Column.from_numpy(emb, VectorType(8))]))
        ctx.sql("CREATE TABLE dup (k INT, w BIGINT)")
        ctx.insert_block("dup", DataBlock(
            ["k", "w"], [Column.from_numpy(dup_k.astype(np.int32)),
                         Column.from_numpy(dup_w.astype(np.int64))]))
        ctx.sql("SET enable_distributed_execution = 1")
        ctx.sql("SET vector_host_scan_max_rows = 0")
        qlit = "[" + ",".join(f"{x:.6f}" for x in q) + "]"
        sqls = {
            "psum_fragment": "SELECT k, sum(v) AS s, count(*) AS c FROM t "
                             "GROUP BY k HAVING sum(v) > 30000 ORDER BY s "
                             "DESC LIMIT 5",
            "knn": f"SELECT id FROM vt ORDER BY l2_distance(emb, {qlit}) "
                   "LIMIT 5",
            "shuffle_join": "SELECT t.v, dup.w FROM t JOIN dup ON t.k = "
                            "dup.k WHERE t.v >= 990 ORDER BY t.v, dup.w",
            "range_sort": "SELECT v FROM t ORDER BY v",
            "window": "SELECT k, v, sum(v) OVER (PARTITION BY k) AS sv "
                      "FROM t ORDER BY k, v LIMIT 10",
        }
        out = {name: [tuple(int(x) for x in r) for r in ctx.sql(s).rows()]
               for name, s in sqls.items()}
        ctx.close()
    finally:
        jm._DEFAULT_MESH = old
    return out


def _rows(arr):
    return [tuple(int(x) for x in r) for r in np.atleast_2d(arr)] \
        if arr.ndim == 2 else [(int(x),) for x in arr]


@pytest.mark.parametrize("name", STATEMENTS)
def test_sql_rows_equal_pandas(sql, name):
    want = _pandas_rows(name)
    assert want
    for r in range(2):
        assert _rows(sql[r][f"rows_{name}"]) == want, r


@pytest.mark.parametrize("name", STATEMENTS)
def test_sql_rows_equal_jax(sql, jax_sql, name):
    for r in range(2):
        assert _rows(sql[r][f"rows_{name}"]) == jax_sql[name], r


@pytest.mark.parametrize("name", STATEMENTS)
def test_sql_exchange_fired(sql, name):
    for r in range(2):
        fired = sql[r][f"fired_{name}"]
        assert fired[FIRED[name]] > 0, (r, fired.tolist())


# ------------------------------------------------------- 4. in one process


def _node(meta, node_id, device="cpu", cards=None):
    extra = {"device": device}
    if cards is not None:
        extra["cards"] = cards
    ClusterDiscovery(meta).register(NodeInfo(
        node_id=node_id, address="localhost:1", extra=extra))


def test_join_times_out_on_too_few_nodes(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    _node(meta, "a")
    with pytest.raises(TimeoutError, match="1/2"):
        multihost.join_cluster_mesh(meta, "a", 2, timeout=0.3)


def test_join_rejects_an_unregistered_node(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    _node(meta, "a")
    _node(meta, "b")
    with pytest.raises(ValueError, match="not in registry"):
        multihost.join_cluster_mesh(meta, "c", 2, timeout=1.0)


@pytest.mark.parametrize("devices, want", [
    ([("cpu", None), ("cpu", None)], "gloo"),
    ([("cuda", "u0"), ("cuda", "u1")], "nccl"),
    ([("cuda", "u0,u1"), ("cuda", "u2,u3")], "nccl"),
    ([("cuda", "u0"), ("cuda", "u0")], "gloo"),
    ([("cuda", "u0,u1"), ("cuda", "u1")], "gloo"),
    ([("cpu", None), ("cuda", "u0")], ValueError),
    ([("cuda", "u0"), ("cuda", "")], ValueError),
    ([("cuda", None), ("cuda", "u0")], ValueError),
])
def test_backend_rule(devices, want):
    nodes = [NodeInfo(node_id=str(i), extra={"device": d, **(
        {} if c is None else {"cards": c})}) for i, (d, c) in
        enumerate(devices)]
    if want is ValueError:
        with pytest.raises(ValueError):
            multihost.choose_backend(nodes)
    else:
        assert multihost.choose_backend(nodes) == want


def test_local_node_registers_its_device():
    node = ClusterDiscovery.local_node(address="localhost:1")
    assert node.extra == {"device": "cpu"}


def test_one_process_meshes_do_not_span():
    cpu = torch.device("cpu")
    for m in (tmesh.make_mesh(4, devices=[cpu] * 4),
              tmesh.make_mesh(8, dp=2, devices=[cpu] * 8),
              tmesh.make_mesh(8, dp=2, devices=[cpu] * 8).regrid(1)):
        assert not tmesh.mesh_spans_processes(m)
        assert m.local_positions() == [
            (i, j) for i in range(m.shape["dp"])
            for j in range(m.shape["shard"])]


def test_remote_positions_in_one_process():
    """A mesh whose owners name another rank: its blocks are markers, the
    per-shard phases skip them, and a collective over them needs a process
    group."""
    cpu = torch.device("cpu")
    devs = np.array([[cpu, cpu, None, None]], dtype=object)
    m = tmesh.Mesh(devs, (tmesh.DP_AXIS, tmesh.SHARD_AXIS),
                   owners=[[0, 0, 1, 1]], rank=0)
    assert tmesh.mesh_spans_processes(m)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    s = tmesh.put_sharded(x, m, tmesh.P(tmesh.SHARD_AXIS, None))
    assert np.array_equal(s.block(0, 1).numpy(), x[2:4])
    with pytest.raises(ValueError, match="rank 1"):
        s.block(0, 2)
    seen = tmesh.per_shard(lambda j, b: j, s.shards())
    assert seen[:2] == [0, 1] and all(tmesh.is_remote(p) for p in seen[2:])
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.psum(s.shards())
    with pytest.raises(ValueError, match="lacks a position"):
        m.regrid(2)


def test_from_process_local_in_one_process():
    cpu = torch.device("cpu")
    m = tmesh.make_mesh(4, devices=[cpu] * 4)
    x = np.arange(24, dtype=np.int64).reshape(8, 3)
    s = tmesh.from_process_local(m, tmesh.P(tmesh.SHARD_AXIS, None), x)
    assert s.shape == (8, 3) and s.dtype == torch.int32
    assert np.array_equal(np.asarray(s), x)
    with pytest.raises(ValueError):
        tmesh.from_process_local(m, tmesh.P(tmesh.DP_AXIS), x)
