"""SQ-u8 scoring: databend_tpu_torch.ops.quantization against the JAX
package's ops/quantization.py on the same seeded numpy inputs (torch on the
CPU, asked for by name).

``encode`` fields are bit-equal; ``approx_dot`` is equal where every term is
exact (an integer corpus in [0, 255] at quantile 1.0: alpha = 1, offset =
0) and within f32 rounding elsewhere; ``topk_l2`` with and without the f32
re-rank returns the reference's ids, on Gaussian rows and on a tied integer
corpus, with values within rtol 1e-5 (the re-rank on tied rows: see
``test_topk_l2_ids_equal``). The int8 product is exact past one
K-slice (D = 1,100 and the +-128 extremes at D = 2,048).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from databend_tpu.ops import quantization as jq

from databend_tpu_torch import backend
from databend_tpu_torch.ops import quantization as tq


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


def _gauss(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


def _integers(n, d, seed, hi=4):
    return np.random.default_rng(seed).integers(0, hi, (n, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("quantile", [0.99, 1.0])
def test_encode_fields_bit_equal(quantile):
    x = _gauss(700, 24, 0)
    a, b = jq.encode(x, quantile), tq.encode(x, quantile)
    assert tuple(b.meta) == tuple(a.meta)
    assert b.codes.dtype == torch.int8
    for field in ("codes", "sums", "sq_norms", "rank_corr"):
        want = np.asarray(getattr(a, field))
        got = backend.to_numpy(getattr(b, field))
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field
    q = _gauss(9, 24, 1)
    for want, got in zip(jq.encode_query(q, a.meta),
                         tq.encode_query(q, b.meta)):
        assert np.array_equal(backend.to_numpy(got), np.asarray(want))


def test_approx_dot_equal_on_integer_codes():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (500, 40)).astype(np.float32)
    x[0, 0], x[1, 0] = 0.0, 255.0          # quantile 1.0: alpha = 1
    q = rng.integers(0, 256, (7, 40)).astype(np.float32)
    a, b = jq.encode(x, 1.0), tq.encode(x, 1.0)
    assert a.meta.alpha == 1.0 and a.meta.offset == 0.0
    want = np.asarray(jq.approx_dot(*jq.encode_query(q, a.meta), a))
    got = backend.to_numpy(tq.approx_dot(*tq.encode_query(q, b.meta), b))
    assert np.array_equal(got, want)
    assert np.array_equal(got, q @ x.T)


def test_approx_dot_gaussian_within_rounding():
    x, q = _gauss(600, 32, 3), _gauss(8, 32, 4)
    a, b = jq.encode(x, 1.0), tq.encode(x, 1.0)
    want = np.asarray(jq.approx_dot(*jq.encode_query(q, a.meta), a))
    got = backend.to_numpy(tq.approx_dot(*tq.encode_query(q, b.meta), b))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# (corpus, queries, quantile). The tied corpus takes values in {0, 85,
# 170, 255} at quantile 1.0 (alpha = 1, offset = 0): every ranking key is an
# exact integer, so equal distances are equal in both packages whatever
# order XLA fuses the multiply-add in, and the tie rule decides.
CORPORA = {
    "gauss": lambda: (_gauss(3000, 32, 5), _gauss(3000, 32, 5)[:12] + 0.05,
                      0.99),
    "tied": lambda: (_integers(2000, 16, 6) * 85, _integers(12, 16, 7) * 85,
                     1.0),
}


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_topk_l2_ids_equal(corpus, rerank):
    x, q, quantile = CORPORA[corpus]()
    a, b = jq.encode(x, quantile), tq.encode(x, quantile)
    va, ia = jq.topk_l2(q, a, 10, x_f32=jnp.asarray(x) if rerank else None)
    vb, ib = tq.topk_l2(q, b, 10, x_f32=backend.to_device(x) if rerank
                        else None)
    ia, va = np.asarray(ia), np.asarray(va)
    ib, vb = backend.to_numpy(ib), backend.to_numpy(vb)
    assert ib.dtype == ia.dtype
    np.testing.assert_allclose(vb, va, rtol=1e-5,
                               atol=1e-5 * np.abs(va).max())
    if corpus == "gauss" or not rerank:
        assert np.array_equal(ib, ia)
        return
    # The re-rank's shortlist is ``approx_min_k`` in the reference, which
    # XLA's CPU backend answers with the exact smallest values but orders
    # (and cuts) equal values otherwise than by ascending position. The
    # port takes the tie rule there too: its ids are the numpy truth
    # (distance, then row id, ascending), its distances bit-equal the
    # reference's, and the ids agree wherever a distance is not tied.
    assert (va[:, :-1] == va[:, 1:]).any()        # the tie rule decides
    assert np.array_equal(vb, va)
    d = ((x[None, :, :] - q[:, None, :]) ** 2).sum(-1)
    truth = np.stack([np.lexsort((np.arange(len(x)), row))[:10] for row in d])
    assert np.array_equal(ib, truth)
    lone = np.array([[(row == v).sum() == 1 for v in vals]
                     for row, vals in zip(d, va)])
    assert lone.any() and np.array_equal(ib[lone], ia[lone])


def test_k_slicing_d1100():
    """D = 1,100 takes two K-slices of the f32 route; the selection and
    the re-rank still equal the reference's, whose int8 product sums in
    int32."""
    x, q = _integers(400, 1100, 8, hi=256), _integers(6, 1100, 9, hi=256)
    a, b = jq.encode(x, 1.0), tq.encode(x, 1.0)
    assert b.codes.shape[1] > tq.K_SLICE
    qa, qb = jq.encode_query(q, a.meta), tq.encode_query(q, b.meta)
    idot = tq.int8_dot(qb[0], b.codes)
    want = backend.to_numpy(qb[0]).astype(np.int64) \
        @ backend.to_numpy(b.codes).astype(np.int64).T
    assert idot.dtype == torch.int32
    assert np.array_equal(backend.to_numpy(idot), want)
    for rerank in (False, True):
        _, ia = jq.topk_l2(q, a, 5, x_f32=jnp.asarray(x) if rerank else None)
        _, ib = tq.topk_l2(q, b, 5, x_f32=backend.to_device(x) if rerank
                           else None)
        assert np.array_equal(backend.to_numpy(ib), np.asarray(ia))


def test_int8_dot_exact_at_the_extremes():
    """Every code -128 at D = 2,048: each dot is 2^25, past f32's exact
    integers; each slice of 1,024 columns sums to 2^24, still exact."""
    a = torch.full((3, 2048), -128, dtype=torch.int8)
    b = torch.full((5, 2048), -128, dtype=torch.int8)
    b[1, ::2] = 127
    out = backend.to_numpy(tq.int8_dot(a, b))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    assert np.array_equal(out, want)
    assert out[0, 0] == 1 << 25
