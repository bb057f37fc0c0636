"""The exchanges: databend_tpu_torch.parallel.{exchange,fragmenter} against
the JAX package's same functions, numpy in and numpy out.

The reference runs on its 8 forced host devices (tests/conftest.py); the
port on a mesh of 8 logical shards of the CPU (torch on the CPU, asked for
by name). Inputs are seeded numpy with ``-1`` pads, empty groups, skewed
keys and ties in the top-n. Outputs must be equal — ids, group rows, sorted
orders, counts, min / max, dtypes — and f32 sums within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from databend_tpu.parallel import exchange as jex
from databend_tpu.parallel import fragmenter as jfr
from databend_tpu.parallel import mesh as jmesh

from databend_tpu_torch import backend
from databend_tpu_torch.parallel import exchange as tex
from databend_tpu_torch.parallel import fragmenter as tfr
from databend_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.make_mesh(8),
            tmesh.make_mesh(8, devices=[torch.device("cpu")] * 8))


def _same(got, want, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    else:
        assert np.array_equal(got, want)


def _agg_inputs(seed, n=1003, groups=60, skew=False):
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, groups - 10, n)       # -1 pads; the top 10 empty
    if skew:
        g[: n * 9 // 10] = 3
    v = np.column_stack([rng.standard_normal(n), np.ones(n),
                         rng.integers(-50, 50, n), rng.standard_normal(n)])
    return g, v, groups


OPS = ["sum", "count", "min", "max"]


@pytest.mark.parametrize("skew", [False, True])
def test_sharded_grouped_agg(meshes, skew):
    g, v, groups = _agg_inputs(0, skew=skew)
    want = jex.sharded_grouped_agg(meshes[0], g, v, groups, OPS)
    got = tex.sharded_grouped_agg(meshes[1], g, v, groups, OPS)
    _same(got[:, 1:], want[:, 1:])
    _same(got, want, rtol=1e-6)
    assert np.isinf(got[-1, 2]) and np.isinf(got[-1, 3])   # empty groups


@pytest.mark.parametrize("case", ["uniform", "wide", "skewed"])
def test_sharded_shuffle_grouped_agg(meshes, case):
    # skewed: 9 rows in 10 in one group, past the guard's floor of 1,024
    # rows a bucket
    g, v, groups = _agg_inputs(1, n=20000 if case == "skewed" else 5000,
                               groups=3000 if case == "wide" else 60,
                               skew=case == "skewed")
    want = jex.sharded_shuffle_grouped_agg(meshes[0], g, v, groups, OPS)
    got = tex.sharded_shuffle_grouped_agg(meshes[1], g, v, groups, OPS)
    if case == "skewed":
        assert want is None and got is None
        return
    _same(got[:, 1:], want[:, 1:])
    _same(got, want, rtol=1e-6)


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("n", [1, 17, 300, 2000])
def test_sharded_topn_ties(meshes, asc, n):
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 20, 1003).astype(np.float32)   # ties everywhere
    keys[5] = -0.0
    keys[6] = 0.0
    _same(tex.sharded_topn(meshes[1], keys, n, asc),
          jex.sharded_topn(meshes[0], keys, n, asc))


def test_broadcast_lookup_join(meshes):
    rng = np.random.default_rng(3)
    build = rng.permutation(400)[:250]
    build[7] = -1                                  # NULL build key
    probe = rng.integers(-1, 420, 1003)
    _same(tex.broadcast_lookup_join(meshes[1], probe, build),
          jex.broadcast_lookup_join(meshes[0], probe, build))


@pytest.mark.parametrize("skew", [False, True])
def test_shuffle_by_key(meshes, skew):
    rng = np.random.default_rng(4)
    keys = rng.integers(-1, 90, 1003)
    if skew:
        keys[:800] = 16
    vals = rng.standard_normal((1003, 2))
    for got, want in zip(tex.shuffle_by_key(meshes[1], keys, vals),
                         jex.shuffle_by_key(meshes[0], keys, vals)):
        _same(got, want)


@pytest.mark.parametrize("skew", [False, True])
def test_shuffle_join(meshes, skew):
    rng = np.random.default_rng(5)
    build = rng.integers(-1, 70, 400)
    probe = rng.integers(-1, 90, 1003)
    if skew:
        build[:200] = 8
        probe[:500] = 8
    got = tex.ShuffleJoin(meshes[1], build).probe(probe)
    want = jex.ShuffleJoin(meshes[0], build).probe(probe)
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("n", [1000, 9000])
def test_range_partition_sort(meshes, n):
    """Unique f32-exact ranks, as the executor rank-compresses them; above
    4,096 rows the splitters come from a sample."""
    keys = np.random.default_rng(6).permutation(n).astype(np.float32)
    _same(tex.range_partition_sort(meshes[1], keys),
          jex.range_partition_sort(meshes[0], keys))


@pytest.mark.parametrize("width", [1, 3, 8])
def test_resize_width_and_rebalance(meshes, width):
    x = np.random.default_rng(7).standard_normal((1003, 3)).astype(np.float32)
    xa, n = jex.shard_rows_padded(meshes[0], x, fill=-1.0)
    xb, _ = tex.shard_rows_padded(meshes[1], x, fill=-1.0)
    ya, ca = jex.resize_width(meshes[0], xa, n, width, fill=-2.0)
    yb, cb = tex.resize_width(meshes[1], xb, n, width, fill=-2.0)
    assert cb == ca
    _same(np.asarray(yb), np.asarray(ya))
    za, _ = jex.rebalance(meshes[0], ya, n)
    zb, _ = tex.rebalance(meshes[1], yb, n)
    _same(np.asarray(zb), np.asarray(za))


HAVING = ("and", ("gt", ("leaf", ("col", 1, -1)), ("const", 2.0)),
          ("not", ("lt", ("leaf", ("avg", 0, 1)), ("const", -0.5))))


@pytest.mark.parametrize("hcode", [None, HAVING], ids=["plain", "having"])
@pytest.mark.parametrize("key", [("col", 0, -1), ("col", 1, -1),
                                 ("avg", 0, 1), ("col", 2, 3)],
                         ids=["sum", "count", "avg", "nullable_min"])
@pytest.mark.parametrize("route", ["psum", "shuffle"])
def test_sharded_grouped_agg_topn(meshes, route, key, hcode):
    """The fused fragment both ways (the shuffle forced by a low threshold),
    ascending and descending, NULLs first and last: a count key ties by
    the dozen, column 3 counts the non-null inputs of the min (0 in some
    groups: NULL keys)."""
    g, v, groups = _agg_inputs(8, n=3000, groups=400)
    nn = (np.random.default_rng(9).random(len(g)) < 0.3).astype(np.float64)
    v = np.column_stack([v[:, :3], nn])
    v[nn == 0, 2] = np.inf
    ops = ["sum", "sum", "min", "sum"]
    kw = {"shuffle_threshold": 10 if route == "shuffle" else 65536}
    for asc, nulls_first in ((True, False), (False, True)):
        want = jfr.sharded_grouped_agg_topn(
            meshes[0], g, v, groups, ops, key, 25, asc, nulls_first, hcode,
            **kw)
        got = tfr.sharded_grouped_agg_topn(
            meshes[1], g, v, groups, ops, key, 25, asc, nulls_first, hcode,
            **kw)
        _same(got[0], want[0])
        _same(got[1], want[1], rtol=1e-6)


def test_grouped_agg_topn_skew_takes_psum(meshes):
    """Above the shuffle threshold, skewed groups fall back to the psum
    fragment in both packages (a host decision, before any upload)."""
    g, v, groups = _agg_inputs(10, n=4000, groups=300, skew=True)
    args = (g, v, groups, OPS, ("col", 1, -1), 9, False, False)
    want = jfr.sharded_grouped_agg_topn(meshes[0], *args, shuffle_threshold=10)
    got = tfr.sharded_grouped_agg_topn(meshes[1], *args, shuffle_threshold=10)
    _same(got[0], want[0])
    _same(got[1], want[1], rtol=1e-6)
