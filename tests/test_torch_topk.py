"""Port parity: databend_tpu_torch.ops.topk against databend_tpu.ops.topk.

Random f32 inputs from a seed (no ties): ids must be equal and values agree
to rtol 1e-5 (sums are taken in a different order). JAX's approx_min_k is
an exact top-k on the CPU backend, so the approx paths compare the same way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.ops import topk as jt
from databend_tpu_torch.ops import topk as tt


def _inputs(seed=0, b=5, n=1024, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x


def _same(got, want, rtol=1e-5):
    gv, gi = got
    wv, wi = want
    np.testing.assert_array_equal(gi.numpy().astype(np.int64),
                                  np.asarray(wi).astype(np.int64))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("ids_kind", ["none", "1d", "2d"])
@pytest.mark.parametrize("approx", [False, True])
def test_topk_smallest_matches_jax(ids_kind, approx):
    rng = np.random.default_rng(1)
    d = rng.standard_normal((4, 200)).astype(np.float32)
    ids = None
    if ids_kind == "1d":
        ids = rng.permutation(200).astype(np.int32) + 1000
    elif ids_kind == "2d":
        ids = rng.integers(0, 10**6, size=(4, 200)).astype(np.int32)
    want = jt.topk_smallest(jnp.asarray(d), 7,
                            None if ids is None else jnp.asarray(ids),
                            approx=approx)
    got = tt.topk_smallest(torch.from_numpy(d), 7,
                           None if ids is None else torch.from_numpy(ids))
    _same(got, want)


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip", "l1"])
@pytest.mark.parametrize("case", ["multiple", "tail", "n_valid", "single"])
def test_chunked_topk_smallest_matches_jax(metric, case):
    n = {"multiple": 1024, "tail": 1000, "n_valid": 1024, "single": 200}[case]
    q, x = _inputs(seed=2, n=n)
    n_valid = 900 if case == "n_valid" else None
    want = jt.chunked_topk_smallest(
        jnp.asarray(q), jnp.asarray(x), 10, metric, chunk_rows=256,
        base_id=7, n_valid=None if n_valid is None else jnp.int32(n_valid))
    got = tt.chunked_topk_smallest(
        torch.from_numpy(q), torch.from_numpy(x), 10, metric, chunk_rows=256,
        base_id=7, n_valid=n_valid)
    _same(got, want)
    if n_valid is not None:
        assert got[1].max().item() < n_valid


def test_chunked_topk_with_norms_matches_jax():
    q, x = _inputs(seed=3, n=1000)
    norms = (x * x).sum(-1).astype(np.float32)
    want = jt.chunked_topk_smallest(jnp.asarray(q), jnp.asarray(x), 10, "l2",
                                    chunk_rows=256,
                                    x_sq_norms=jnp.asarray(norms))
    got = tt.chunked_topk_smallest(torch.from_numpy(q), torch.from_numpy(x),
                                   10, "l2", chunk_rows=256,
                                   x_sq_norms=torch.from_numpy(norms))
    _same(got, want)


@pytest.mark.parametrize("stacked", [True, False])
def test_merge_topk_matches_jax(stacked):
    rng = np.random.default_rng(4)
    shape = (3, 4, 6) if stacked else (4, 18)
    d = rng.standard_normal(shape).astype(np.float32)
    ids = rng.permutation(np.prod(shape)).astype(np.int32).reshape(shape)
    want = jt.merge_topk(jnp.asarray(d), jnp.asarray(ids), 5)
    got = tt.merge_topk(torch.from_numpy(d), torch.from_numpy(ids), 5)
    _same(got, want)


@pytest.mark.parametrize("n", [1000, 1024])
def test_pad_corpus_matches_jax(n):
    _, x = _inputs(seed=5, n=n)
    jx, jn = jt.pad_corpus(x, 256)
    tx, tn = tt.pad_corpus(x, 256)
    assert jn == tn == n
    np.testing.assert_array_equal(np.asarray(jx), np.asarray(tx))


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_brute_force_topk_f32_matches_jax(metric):
    q, x = _inputs(seed=6, n=1000)
    want = jt.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10, metric,
                               chunk_rows=256)
    got = tt.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10,
                              metric, chunk_rows=256)
    _same(got, want)


def test_brute_force_topk_bf16_matches_jax():
    q, x = _inputs(seed=7, n=1000)
    want = jt.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10, "l2",
                               chunk_rows=256, bf16=True)
    got = tt.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x), 10,
                              "l2", chunk_rows=256, bf16=True)
    wv, wi = (np.asarray(a) for a in want)
    gv, gi = got[0].numpy(), got[1].numpy()
    # bf16 scores: near-ties at rank 10 may swap; values to bf16 accuracy
    hits = sum(len(set(wi[b]) & set(gi[b])) for b in range(wi.shape[0]))
    assert hits / wi.size >= 0.9
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-3 * np.abs(wv).max())


@pytest.mark.parametrize("metric", ["l2", "l2_sq", "ip", "cosine"])
def test_rerank_topk_matches_jax(metric):
    q, x = _inputs(seed=8, n=2000)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    norms = (x * x).sum(-1).astype(np.float32)
    want = jt.rerank_topk(jnp.asarray(q), jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(norms), jnp.asarray(x), 10, metric)
    got = tt.rerank_topk(torch.from_numpy(q),
                         torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(norms), torch.from_numpy(x), 10,
                         metric)
    _same(got, want)


def test_rerank_topk_rejects_l1():
    q, x = _inputs()
    with pytest.raises(ValueError):
        tt.rerank_topk(torch.from_numpy(q), torch.from_numpy(x).bfloat16(),
                       torch.zeros(x.shape[0]), torch.from_numpy(x), 5, "l1")


def _tie_rows(seed, b=6, n=700):
    """Rows that tie by the hundred: a few distinct values (both zeros
    among them), runs of -inf, and a row of one value."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1.5, -2.0, 3.25, -np.inf], np.float32)
    rows = pool[rng.integers(0, len(pool), (b, n))]
    rows[1, 100:400] = -np.inf
    rows[2] = -0.0
    rows[3, ::2] = 0.0
    rows[3, 1::2] = -0.0
    return rows


@pytest.mark.parametrize("k", [1, 10, 250, 700])
def test_topk_largest_lowest_index_matches_lax_top_k(k):
    """The total order of float32 (-0.0 below +0.0), equal values by
    ascending index, ``k`` up to the row length."""
    import jax

    rows = _tie_rows(k)
    wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
    gv, gi = tt.topk_largest_lowest_index(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gv.numpy().tobytes() == np.asarray(wv).tobytes()


def test_topk_largest_lowest_index_signed_zeros():
    row = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -np.inf, -np.inf]],
                   np.float32)
    _, ids = tt.topk_largest_lowest_index(torch.from_numpy(row), 7)
    assert ids.tolist() == [[4, 0, 2, 1, 3, 5, 6]]


@pytest.mark.parametrize("chunk_rows", [64, 100, 4096])
def test_chunked_lowest_index_ties_signed_zeros_match_jax(chunk_rows):
    """Inner-product distances ``-dot`` of a zero query against rows of
    mixed sign take both signs of zero; the reference selects them with
    ``jax.lax.top_k(-dists)``, so +0.0 distances rank before -0.0 ones."""
    rng = np.random.default_rng(9)
    x = -np.abs(rng.standard_normal((600, 1))).astype(np.float32)
    x[rng.choice(600, 25, replace=False)] *= -1.0
    q = np.zeros((3, 1), np.float32)
    q[1] = -0.0
    q[2] = 1.0
    want = jt.chunked_topk_smallest(jnp.asarray(q), jnp.asarray(x), 40, "ip",
                                    chunk_rows=chunk_rows)
    got = tt.chunked_topk_smallest(torch.from_numpy(q), torch.from_numpy(x),
                                   40, "ip", chunk_rows=chunk_rows,
                                   lowest_index_ties=True)
    wv, wi = (np.asarray(a) for a in want)
    zeros = wv[:2] == 0.0
    assert np.signbit(wv[:2][zeros]).any() and (~np.signbit(
        wv[:2][zeros])).any()                    # both zeros are selected
    np.testing.assert_array_equal(got[1].numpy(), wi.astype(np.int64))
    assert got[0].numpy().tobytes() == wv.tobytes()
