"""k-means for CLUSTER BY: the port's torch Lloyd's iteration against the
JAX package's, and a CLUSTER BY (vector) table through both SessionContexts.

Inputs come from a numpy seed. Assignments, cluster orders and block
layouts must be equal; centroids and distances to the own centroid agree
to rtol/atol 1e-5 (f32 sums over up to 4,096 rows, in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.index import kmeans as jkm
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.index import kmeans as tkm
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing

N, D, K, SEED = 4096, 32, 16, 3


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv(backend.DEVICE_ENV, "cpu")


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    """Statements on either SessionContext record spans in their package's
    process-wide ring; empty both after the module, so that a later test
    file on this worker (tests/test_explain_profile.py) reads only its own
    spans."""
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _blobs(n=N, d=D, k=K, seed=SEED, blobs=None):
    """Well-separated blobs of small integers: integer centres in
    [-20, 20], and each blob's rows come in pairs ``c + v``, ``c - v`` with
    ``v`` in [-3, 3]. The rows the LCG seeding picks lie one in each blob,
    so Lloyd's iteration finds the blobs, every centroid is the exact
    integer centre and every distance is exact in f32 whatever the order
    of the sums: the two frameworks then agree bit for bit, including
    near-ties of the distance to the own centroid, which the sort order
    of ``cluster_layout`` depends on."""
    blobs = k if blobs is None else blobs
    rng = np.random.default_rng(seed)
    centres = rng.integers(-20, 21, size=(blobs, 1, d))
    v = rng.integers(-3, 4, size=(blobs, n // blobs // 2, d))
    rows = np.concatenate([centres + v, centres - v], 1).astype(np.float32)
    n = rows.shape[0] * rows.shape[1]
    pools = [list(rng.permutation(rows.shape[1])) for _ in range(blobs)]
    x = np.empty((n, d), np.float32)
    seeded = np.zeros(n, bool)
    for i, pos in enumerate(jkm._lcg_indices(n, k)):
        x[pos] = rows[i % blobs, pools[i % blobs].pop()]
        seeded[pos] = True
    rest = np.concatenate([rows[b, pools[b]] for b in range(blobs)])
    x[~seeded] = rest[rng.permutation(len(rest))]
    return x


@pytest.mark.parametrize("case", ["blobs", "empty"])
def test_lloyd_matches_jax(case):
    # "empty": a centroid far from every row keeps no row and stays put
    x = _blobs(blobs=K - 1 if case == "empty" else K)
    init = x[jkm._lcg_indices(x.shape[0], K)].copy()
    if case == "empty":
        init[-1] = 300.0
    jc, ja, jo = (np.asarray(a) for a in jkm._lloyd(
        jnp.asarray(x), jnp.asarray(init), iters=10))
    tc, ta, to = (t.numpy() for t in tkm._lloyd(
        torch.from_numpy(x), torch.from_numpy(init), iters=10))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    if case == "empty":
        assert not (ta == K - 1).any()
        np.testing.assert_array_equal(tc[-1], init[-1])


@pytest.mark.parametrize("k", [K, 64])
def test_cluster_layout_matches_jax(k):
    x = _blobs(k=k)
    jo, jr = jkm.cluster_layout(x, k=k)
    to, tr = tkm.cluster_layout(x, k=k)
    np.testing.assert_array_equal(to, jo)
    assert tr == jr
    np.testing.assert_array_equal(tkm.cluster_sort_order(x, k=k),
                                  jkm.cluster_sort_order(x, k=k))


def _load(ctx, expr_mod, types_mod, x):
    n, d = x.shape
    ctx.sql(f"CREATE TABLE c (id BIGINT, emb VECTOR({d}), VECTOR INDEX cv "
            "(emb) distance='l2') CLUSTER BY (emb) "
            "ROW_PER_BLOCK='1024'")
    ctx.insert_block("c", expr_mod.DataBlock(
        ["id", "emb"],
        [expr_mod.Column.from_numpy(np.arange(n, dtype=np.int64)),
         expr_mod.Column.from_numpy(x, types_mod.VectorType(d))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")


def _layout(ctx):
    t = ctx.table("c")
    metas = [m for s in t.read_segments(t.read_snapshot()) for m in s.blocks]
    return [t.read_block(m, ["id"]).column("id").to_pylist() for m in metas]


def test_cluster_by_table_matches_jax(tmp_path):
    x = _blobs(k=tkm.MAX_CLUSTERS)
    noise = np.random.default_rng(SEED + 1).standard_normal((2, D))
    q = x[[5, 1234]] + 0.3 * noise.astype(np.float32)
    j = JaxContext(str(tmp_path / "jax"))
    t = TorchContext(str(tmp_path / "torch"))
    try:
        _load(j, jexpr, jtypes, x)
        _load(t, texpr, ttypes, x)
        jl, tl = _layout(j), _layout(t)
        assert len(tl) > 1
        assert tl == jl
        assert sorted(i for b in tl for i in b) == list(range(len(x)))
        for v in q:
            lit = "[" + ",".join(f"{f:.6f}" for f in v) + "]"
            for fn in ("l2_distance", "cosine_distance"):
                sql = f"SELECT id FROM c ORDER BY {fn}(emb, {lit}) LIMIT 10"
                assert t.sql(sql).rows() == j.sql(sql).rows()
    finally:
        j.close()
        t.close()
