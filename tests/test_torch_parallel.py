"""The mesh and the sharded vector programs: databend_tpu_torch.parallel
against the JAX package's parallel/{mesh,distributed}.py.

The reference runs on its 8 forced host devices (tests/conftest.py); the
port on meshes of 8 logical shards of the CPU (torch on the CPU, asked for
by name), of the same ``(dp, shard)`` shapes, fed the same seeded numpy
inputs. Exact f32 top-k returns the reference's ids — with n not a multiple
of the shards, k above the rows a shard holds, and on a tied integer corpus
where only the tie rule decides — and its distances within f32 rounding;
the partial aggregates and the k-means step agree to f32 rounding, counts
exactly; the bf16 search step is held to recall and to f32 re-scored
distances. The collectives are checked on their own.
"""

import jax
import numpy as np
import pytest
import torch

from databend_tpu import parallel as jp

from databend_tpu_torch import backend
from databend_tpu_torch import parallel as tp
from databend_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module", params=[1, 2], ids=["dp1", "dp2"])
def meshes(request):
    dp = request.param
    return jp.make_mesh(8, dp=dp), tp.make_mesh(8, dp=dp, devices=CPU8)


def _put(meshes, x, which):
    jm, tm = meshes
    return (jax.device_put(x, getattr(jp, which)(jm)),
            tmesh.device_put(x, getattr(tp, which)(tm)))


def _topk_both(meshes, x, q, k, metric, **kw):
    jm, tm = meshes
    xa, nv = jp.shard_rows(x, jm)
    xb, nv_b = tp.shard_rows(x, tm)
    assert nv_b == nv and xb.shape == xa.shape
    qa, qb = _put(meshes, q, "query_sharding")
    da, ia = jp.sharded_brute_force_topk(jm, qa, xa, k, metric,
                                         n_valid=nv, **kw)
    db, ib = tp.sharded_brute_force_topk(tm, qb, xb, k, metric,
                                         n_valid=nv, **kw)
    return (np.asarray(da), np.asarray(ia)), (np.asarray(db), np.asarray(ib))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_sharded_topk_ids_equal(meshes, metric):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1001, 24)).astype(np.float32)  # 1001 % 8 != 0
    q = rng.standard_normal((6, 24)).astype(np.float32)
    (da, ia), (db, ib) = _topk_both(meshes, x, q, 10, metric)
    assert ib.dtype == ia.dtype == np.int32
    assert db.dtype == np.float32
    assert np.array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=1e-5, atol=1e-5)
    assert ib.max() < 1001


def test_sharded_topk_k_above_a_shards_rows(meshes):
    """k = 300 is more than the 126-251 rows a shard holds: each shard
    returns all its rows, the merge picks across them."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1001, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    (da, ia), (db, ib) = _topk_both(meshes, x, q, 300, "l2")
    assert np.array_equal(ib, ia)
    np.testing.assert_allclose(db, da, rtol=1e-5, atol=1e-5)


def test_sharded_topk_tied_integer_corpus(meshes):
    """Integer rows in [0, 3): distances are exact and tie by the hundred;
    ids must follow the tie rule (ascending global id), also across the
    chunks of a shard (chunk_rows = 32) and the shards."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 3, (999, 8)).astype(np.float32)
    q = rng.integers(0, 3, (6, 8)).astype(np.float32)
    for metric in ("l2", "ip"):
        (da, ia), (db, ib) = _topk_both(meshes, x, q, 50, metric,
                                        chunk_rows=32)
        assert (da[:, 1:] == da[:, :-1]).any()
        assert np.array_equal(ib, ia), metric
        assert np.array_equal(db, da), metric


@pytest.mark.parametrize("op", ["sum", "max", "min", "count"])
def test_sharded_partial_agg(meshes, op):
    x = np.random.default_rng(3).standard_normal((800, 4)).astype(np.float32)
    xa, xb = _put(meshes, x, "corpus_sharding")
    want = np.asarray(jp.sharded_partial_agg(meshes[0], xa, op))
    got = np.asarray(tp.sharded_partial_agg(meshes[1], xb, op))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_sharded_kmeans_step(meshes):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((512, 8)).astype(np.float32)
    cent = np.concatenate([x[:4], np.full((1, 8), 50.0, np.float32)])
    xa, xb = _put(meshes, x, "corpus_sharding")
    ca, cb = _put(meshes, cent, "replicated")
    na, ka = jp.sharded_kmeans_step(meshes[0], xa, ca)
    nb, kb = tp.sharded_kmeans_step(meshes[1], xb, cb)
    assert np.array_equal(np.asarray(kb), np.asarray(ka))
    assert np.asarray(kb)[4] == 0                 # empty: keeps its centroid
    np.testing.assert_allclose(np.asarray(nb), np.asarray(na), rtol=1e-5,
                               atol=1e-5)


def test_sharded_search_step_dp2():
    """The flagship step on a (2, 4) mesh, bf16 scan: recall against the
    reference's f32 answer, distances re-scored in f32, and the k-means
    half equal to the reference's."""
    jm, tm = jp.make_mesh(8, dp=2), tp.make_mesh(8, dp=2, devices=CPU8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    q = x[rng.integers(0, 2048, 8)] + 0.01
    cent = x[:16].copy()
    xa, _ = jp.shard_rows(x, jm)
    xb, _ = tp.shard_rows(x, tm)
    qa, qb = _put((jm, tm), q, "query_sharding")
    ca, cb = _put((jm, tm), cent, "replicated")
    da, ia, na, ka = jp.sharded_search_step(jm, qa, xa, ca, 10)
    db, ib, nb, kb = tp.sharded_search_step(tm, qb, xb, cb, 10)
    ia, ib = np.asarray(ia), np.asarray(ib)
    hits = sum(len(set(a) & set(b)) for a, b in zip(ia, ib))
    assert hits / ia.size >= 0.95

    def rescored(ids):
        return np.sort(np.sqrt(((x[ids] - q[:, None, :]) ** 2).sum(-1)), 1)

    np.testing.assert_allclose(rescored(ib), rescored(ia), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(db), np.asarray(da), atol=1e-2)
    assert int(np.asarray(kb).sum()) == 2048
    assert np.array_equal(np.asarray(kb), np.asarray(ka))
    np.testing.assert_allclose(np.asarray(nb), np.asarray(na), rtol=1e-5,
                               atol=1e-5)


def test_put_sharded_layout_and_dtypes():
    m = tp.make_mesh(8, dp=2, devices=CPU8)
    x = np.arange(48, dtype=np.int64).reshape(8, 6)
    s = tmesh.put_sharded(x, m, tmesh.P(tmesh.SHARD_AXIS, None))
    assert s.dtype == torch.int32                   # no x64, as in jax
    assert np.array_equal(np.asarray(s), x)
    assert np.array_equal(s.block(1, 2).numpy(), x[4:6])
    assert s.block(0, 2) is s.block(1, 2)           # one device: one copy
    q = tmesh.put_sharded(x.astype(np.float64), m, tmesh.P(tmesh.DP_AXIS))
    assert q.dtype == torch.float32
    assert np.array_equal(q.block(1, 0).numpy(), x[4:].astype(np.float32))
    with pytest.raises(ValueError):
        tmesh.put_sharded(np.zeros((5, 2)), m, tmesh.P(tmesh.SHARD_AXIS))
    assert not tmesh.mesh_spans_processes(m)


def test_collectives():
    parts = [torch.arange(6).reshape(3, 2) + 10 * i for i in range(3)]
    gathered = tmesh.all_gather(parts)
    assert gathered[0] is gathered[2]               # one device, one result
    assert torch.equal(gathered[1], torch.stack(parts))
    assert torch.equal(tmesh.all_gather(parts, tiled=True)[0],
                       torch.cat(parts))
    assert torch.equal(tmesh.psum(parts)[0], parts[0] + parts[1] + parts[2])
    assert torch.equal(tmesh.pmax(parts)[0], parts[2])
    assert torch.equal(tmesh.pmin(parts)[0], parts[0])
    recv = tmesh.all_to_all(parts)
    for i in range(3):                              # bucket i -> shard i
        assert torch.equal(recv[i], torch.stack([p[i] for p in parts]))


def test_default_mesh_install():
    """One device: no mesh unless one is installed, as in the reference."""
    old = tmesh.set_default_mesh(None)
    try:
        assert tmesh.get_default_mesh() is None
        m = tp.make_mesh(4, devices=CPU8)
        assert tmesh.set_default_mesh(m) is None
        assert tmesh.get_default_mesh() is m
        assert m.shape == {"dp": 1, "shard": 4}
    finally:
        tmesh.set_default_mesh(old)
