"""Port parity: databend_tpu_torch.ops.flash_topk against
databend_tpu.ops.flash_topk.

On the CPU the port's ``flash_group_minima`` runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_topk.py does. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.

Tolerances: group minima atol 1e-4 * max|score| (bf16 operands on both
sides, f32 sums in different orders); flash_topk ids agree >= 0.99 and the
re-scored f32 distances agree to rtol 1e-5 on the shared ids.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.ops import flash_topk as jf
from databend_tpu_torch.ops import flash_topk as tf


def _mk(seed=0, n=1000, d=32, b=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.integers(0, n, size=b)] \
        + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    norms = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return q, x, norms


def _bf16(x):
    """numpy f32 -> torch bf16 (rounds as ``jnp.asarray(x, jnp.bfloat16)``)."""
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_group_minima_plain_matches_pallas(metric):
    q, x, norms = _mk()
    if metric == "ip":
        norms = np.zeros_like(norms)
    xp, npad, _ = jf.pad_for_flash(x, norms, 256)      # pad rows: +inf norms
    want = np.asarray(jf.flash_group_minima(
        q, jnp.asarray(xp, jnp.bfloat16), npad, metric, tile=256,
        buckets=128, interpret=True))
    got = tf.flash_group_minima(torch.from_numpy(q), _bf16(xp),
                                torch.from_numpy(npad), metric, tile=256,
                                buckets=128).numpy()
    assert got.shape == want.shape == (4, 8, 128)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=1e-4 * np.abs(want[finite]).max())


def test_group_minima_membership():
    """Group (t, lane) holds rows t*tile + g*L + lane (checked in numpy)."""
    q, x, norms = _mk(seed=1, n=512, d=16, b=3)
    tile, lanes = 256, 128
    got = tf.flash_group_minima(torch.from_numpy(q), _bf16(x),
                                torch.from_numpy(norms), "l2", tile=tile,
                                buckets=lanes).numpy()
    qb = _bf16(q).float().numpy()
    xb = _bf16(x).float().numpy()
    scores = norms[None, :] - 2.0 * (qb @ xb.T)
    for t in range(512 // tile):
        for lane in (0, 5, 127):
            rows = t * tile + np.arange(tile // lanes) * lanes + lane
            np.testing.assert_allclose(got[t, :, lane],
                                       scores[:, rows].min(axis=1),
                                       rtol=1e-5, atol=1e-3)


def test_pad_for_flash_matches_jax():
    _, x, norms = _mk(seed=2)
    jx, jn, jv = jf.pad_for_flash(x, norms, 256)
    tx, tn, tv = tf.pad_for_flash(torch.from_numpy(x), torch.from_numpy(norms),
                                  256)
    assert jv == tv == 1000
    np.testing.assert_array_equal(tx.numpy(), jx)
    np.testing.assert_array_equal(tn.numpy(), jn)
    same = tf.pad_for_flash(torch.zeros(512, 4), torch.zeros(512), 256)
    assert same[0].shape[0] == 512 and same[2] == 512


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flash_topk_matches_jax(metric):
    q, x, norms = _mk(seed=3)
    q = 0.01 * q if metric == "l2" else q     # near the origin: pads would win
    if metric == "ip":
        norms = np.zeros_like(norms)
    xp, npad, n_valid = jf.pad_for_flash(x, norms, 256)
    wv, wi = jf.flash_topk(q, jnp.asarray(xp, jnp.bfloat16), npad, xp, 10,
                           metric, tile=256, buckets=128,
                           n_valid=jnp.int32(n_valid), interpret=True)
    wv, wi = np.asarray(wv), np.asarray(wi)
    gv, gi = tf.flash_topk(torch.from_numpy(q), _bf16(xp),
                           torch.from_numpy(npad), torch.from_numpy(x), 10,
                           metric, tile=256, buckets=128, n_valid=n_valid)
    gv, gi = gv.numpy(), gi.numpy()
    assert gi.max() < n_valid
    hits = 0
    for b in range(q.shape[0]):
        shared = np.intersect1d(wi[b], gi[b])
        hits += len(shared)
        for r in shared:
            np.testing.assert_allclose(gv[b][gi[b] == r], wv[b][wi[b] == r],
                                       rtol=1e-5)
    assert hits / wi.size >= 0.99


def test_flash_topk_zero_padded_columns():
    """x_bf16 may carry zero columns past q's width (the kernel needs
    D % 16 == 0): the answer is unchanged."""
    q, x, norms = _mk(seed=4, d=24)
    qt, xt, nt = torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms)
    xb, npad, nv = tf.pad_for_flash(_bf16(x), nt, 256)
    xb32 = torch.nn.functional.pad(xb, (0, 8))
    v1, i1 = tf.flash_topk(qt, xb, npad, xt, 10, "l2", tile=256, n_valid=nv)
    v2, i2 = tf.flash_topk(qt, xb32, npad, xt, 10, "l2", tile=256, n_valid=nv)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)


def test_flash_group_minima_checks_inputs():
    q, x, norms = _mk(seed=5, n=512)
    qt, xb, nt = torch.from_numpy(q), _bf16(x), torch.from_numpy(norms)
    with pytest.raises(ValueError):          # N not a multiple of tile
        tf.flash_group_minima(qt, xb[:500], nt[:500], "l2", tile=256)
    with pytest.raises(TypeError):           # f32 corpus
        tf.flash_group_minima(qt, xb.float(), nt, "l2", tile=256)
    with pytest.raises(ValueError):          # unknown metric
        tf.flash_group_minima(qt, xb, nt, "l1", tile=256)


def test_flash_group_minima_has_no_fallback_off_cpu():
    """Only a CPU tensor takes the plain version; other devices never fall
    back to it (a CUDA tensor launches the kernel or raises)."""
    q, x, norms = _mk(seed=6, n=512)
    before = tf.flash_group_minima.launches
    with pytest.raises(ValueError):
        tf.flash_group_minima(torch.from_numpy(q).to("meta"),
                              _bf16(x).to("meta"),
                              torch.from_numpy(norms).to("meta"), "l2",
                              tile=256)
    tf.flash_group_minima(torch.from_numpy(q), _bf16(x),
                          torch.from_numpy(norms), "l2", tile=256)
    assert tf.flash_group_minima.launches == before   # plain runs count 0
