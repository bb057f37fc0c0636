"""Port parity: databend_tpu_torch.ops.distance against databend_tpu.ops.distance.

The same numpy inputs (from a seed) go through the JAX function and its
torch port on the CPU. Tolerances: f32 rtol 1e-5 / atol 1e-5 (the two
frameworks sum in different orders); bf16 atol 1e-3 * max|value| (both
sides round the operands to bf16 the same way and accumulate in f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.ops import distance as jd
from databend_tpu_torch.ops import distance as td

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, b=6, n=300, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())


_PAIRWISE = {
    "inner_product": lambda m, q, x, cd: m.inner_product(q, x, cd),
    "cosine_distance": lambda m, q, x, cd: m.cosine_distance(q, x, cd),
    "cosine_distance_normalized": lambda m, q, x, cd: m.cosine_distance(
        q, m.normalize(x), cd, x_normalized=True),
    "l2_distance_squared": lambda m, q, x, cd: m.l2_distance_squared(q, x, cd),
    "l2_distance": lambda m, q, x, cd: m.l2_distance(q, x, cd),
    "pairwise_l2_sq": lambda m, q, x, cd: m.pairwise_distance(q, x, "l2_sq", cd),
    "pairwise_cosine": lambda m, q, x, cd: m.pairwise_distance(q, x, "cosine", cd),
    "pairwise_ip": lambda m, q, x, cd: m.pairwise_distance(q, x, "ip", cd),
    "pairwise_l2": lambda m, q, x, cd: m.pairwise_distance(q, x, "l2", cd),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(_PAIRWISE))
def test_pairwise_matches_jax(name, dtype):
    q, x = _inputs()
    jcd, tcd = DTYPES[dtype]
    fn = _PAIRWISE[name]
    want = fn(jd, jnp.asarray(q), jnp.asarray(x), jcd)
    got = fn(td, torch.from_numpy(q), torch.from_numpy(x), tcd)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, dtype)


def test_l2_with_precomputed_norms_matches_jax():
    q, x = _inputs(seed=1)
    norms = (x * x).sum(-1).astype(np.float32)
    want = jd.l2_distance(jnp.asarray(q), jnp.asarray(x),
                          x_sq_norms=jnp.asarray(norms))
    got = td.l2_distance(torch.from_numpy(q), torch.from_numpy(x),
                         x_sq_norms=torch.from_numpy(norms))
    _close(got.numpy(), want, "f32")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normalize_matches_jax(dtype):
    _, x = _inputs(seed=2)
    x[3] = 0.0                                   # zero rows stay zero
    jdt, tdt = DTYPES[dtype]
    want = jd.normalize(jnp.asarray(x).astype(jdt))
    got = td.normalize(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    assert not got[3].any()


@pytest.mark.parametrize("n", [256, 300, 40])   # chunk multiple, tail, n < chunk
def test_l1_distance_chunked_matches_jax(n):
    q, x = _inputs(seed=3, n=n)
    want = jd.l1_distance(jnp.asarray(q), jnp.asarray(x), chunk=64)
    got = td.l1_distance(torch.from_numpy(q), torch.from_numpy(x), chunk=64)
    _close(got.numpy(), want, "f32")


def test_pairwise_l1_matches_jax():
    q, x = _inputs(seed=4, n=2048)
    want = jd.pairwise_distance(jnp.asarray(q), jnp.asarray(x), "l1")
    got = td.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "l1")
    _close(got.numpy(), want, "f32")


@pytest.mark.parametrize("metric", ["cosine", "l2", "l2_sq", "l1", "ip"])
def test_rowwise_matches_jax(metric):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((200, 24)).astype(np.float32)
    b = rng.standard_normal((200, 24)).astype(np.float32)
    want = jd.rowwise_distance(jnp.asarray(a), jnp.asarray(b), metric)
    got = td.rowwise_distance(torch.from_numpy(a), torch.from_numpy(b), metric)
    _close(got.numpy(), want, "f32")


def test_unknown_metric_raises():
    q, x = _inputs()
    with pytest.raises(ValueError):
        td.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "hamming")
    with pytest.raises(ValueError):
        td.rowwise_distance(torch.from_numpy(q), torch.from_numpy(q), "hamming")
