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


# (metric, B, D, tile, N): the first two are the original small cases; the
# rest are the ragged shapes the CUDA kernel takes (a partial block of 128
# queries, three blocks with the last partial, a single box of 48 columns, a
# last box of 16 valid columns, one step per tile, 32 steps per tile), so the
# yardstick chip_smoke.py holds the kernel against is known right there.
# Every corpus is padded to its tile: pad rows carry +inf norms.
_MINIMA_CASES = [
    ("l2", 8, 32, 256, 1000), ("ip", 8, 32, 256, 1000),
    ("l2", 100, 128, 4096, 6000), ("ip", 100, 128, 4096, 6000),
    ("l2", 300, 128, 128, 1000), ("ip", 300, 128, 128, 1000),
    ("l2", 100, 48, 4096, 5000), ("ip", 300, 48, 128, 700),
    ("l2", 100, 400, 128, 900), ("ip", 300, 400, 4096, 4500),
]


@pytest.mark.parametrize("metric,b,d,tile,n", _MINIMA_CASES)
def test_group_minima_plain_matches_pallas(metric, b, d, tile, n):
    q, x, norms = _mk(n=n, d=d, b=b)
    if metric == "ip":
        norms = np.zeros_like(norms)
    xp, npad, _ = jf.pad_for_flash(x, norms, tile)     # pad rows: +inf norms
    assert xp.shape[0] > n and xp.shape[0] % tile == 0
    want = np.asarray(jf.flash_group_minima(
        q, jnp.asarray(xp, jnp.bfloat16), npad, metric, tile=tile,
        buckets=128, interpret=True))
    got = tf.flash_group_minima(torch.from_numpy(q), _bf16(xp),
                                torch.from_numpy(npad), metric, tile=tile,
                                buckets=128).numpy()
    assert got.shape == want.shape == (xp.shape[0] // tile, b, 128)
    finite = np.isfinite(want)
    # a lane is +inf only where every row of its group is a pad
    assert finite.all() == (tile != 128)
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


@pytest.mark.parametrize("n", [780, 1000])
def test_flash_topk_serving_form_matches_jax_exactly(n):
    """The form the server calls: whole-number rows up to 255 (every bf16
    operand, product and f32 sum exact, so both sides pick the same groups
    and scores), an f32 corpus of the real rows alone, and queries at the
    last real row, whose group and neighbours hold padding rows (at n = 780
    every group of the last tile does). Ids and distances equal."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, size=(n, 32)).astype(np.float32)
    q = x[rng.integers(0, n, size=8)]
    q[:2] = x[n - 1]
    q[1:] += rng.integers(-3, 4, size=q[1:].shape)
    q = np.clip(q, 0, 255)
    norms = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    xp, npad, n_valid = jf.pad_for_flash(x, norms, 256)
    assert n_valid == n and xp.shape[0] == 1024
    wv, wi = jf.flash_topk(q, jnp.asarray(xp, jnp.bfloat16), npad, x, 10,
                           "l2", tile=256, buckets=128,
                           n_valid=jnp.int32(n_valid), interpret=True)
    gv, gi = tf.flash_topk(torch.from_numpy(q), _bf16(xp),
                           torch.from_numpy(npad), torch.from_numpy(x), 10,
                           "l2", tile=256, buckets=128, n_valid=n_valid)
    assert gi[0, 0] == n - 1 and gv[0, 0] == 0
    assert all(len(set(row)) == 10 for row in gi.tolist())
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


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


def _misaligned(t):
    """The same values in a contiguous tensor that starts one element (2 or
    4 bytes) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("bad", ["qn", "x_bf16", "norms"])
@pytest.mark.parametrize("how", ["misaligned", "strided"])
def test_tma_operand_check(bad, how):
    """The kernel reads its operands with TMA: the wrapper's check raises
    on an operand that is not contiguous or not 16-byte aligned."""
    q, x, norms = _mk(seed=7, n=512)
    good = {"qn": _bf16(q), "x_bf16": _bf16(x), "norms": torch.from_numpy(norms)}
    tf._check_tma_operands(**good)                     # torch allocations pass
    t = good[bad]
    if how == "misaligned":
        good[bad] = _misaligned(t)
    else:
        good[bad] = torch.cat([t, t], dim=-1)[..., ::2]
        assert not good[bad].is_contiguous()
    with pytest.raises(ValueError, match=bad):
        tf._check_tma_operands(**good)


def test_cuda_source_exports_what_the_wrapper_binds():
    """Nothing compiles on the CPU: read the kernel's source and check that
    its extern "C" block exports exactly the two functions `_launcher`
    binds, with as many arguments as the ctypes signatures."""
    import ctypes
    import os
    import re
    from databend_tpu_torch.ops import _cuda
    with open(os.path.join(_cuda.CSRC_DIR, "flash_group_minima.cu")) as f:
        src = f.read()
    assert src.count('extern "C" {') == 1
    block = re.sub(r"//[^\n]*", "", src[src.index('extern "C" {'):])
    exported = {name: [a for a in args.split(",") if a.strip()]
                for name, args in re.findall(      # definitions at column 0
                    r"^\w[^\n(]*?\b(\w+)\s*\(([^)]*)\)\s*\{", block, re.M)}
    assert set(exported) == {"flash_group_minima_launch",
                             "flash_group_minima_error_string"}
    args = exported["flash_group_minima_launch"]
    assert len(args) == len(tf._LAUNCH_ARGTYPES) == 9
    for arg, ctype in zip(args, tf._LAUNCH_ARGTYPES):
        assert ("*" in arg) == (ctype is ctypes.c_void_p), arg
    assert len(exported["flash_group_minima_error_string"]) == 1
    # one design: wgmma fed by TMA, no trace of the wmma kernel or a switch
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier"):
        assert needle in src
    for needle in ("nvcuda", "wmma::", "getenv"):
        assert needle not in src


def _rerank_inputs(seed=8, n=1000, d=32, b=8, tile=256, metric="l2"):
    """(minima, q, x) as the server hands them to flash_rerank: the group
    minima of the plain scan over the padded bf16 copy, f32 queries, the
    real f32 rows alone."""
    q, x, norms = _mk(seed=seed, n=n, d=d, b=b)
    if metric == "ip":
        norms = np.zeros_like(norms)
    xb, npad, _ = tf.pad_for_flash(_bf16(x), torch.from_numpy(norms), tile)
    qt = torch.from_numpy(q)
    return (tf.flash_group_minima(qt, xb, npad, metric, tile=tile), qt,
            torch.from_numpy(x))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_valid", [None, 1000, 900])
def test_flash_rerank_cpu_is_the_plain_version(metric, n_valid):
    """On CPU tensors the wrapper returns the plain version's answer, and
    counts no launch."""
    minima, q, x = _rerank_inputs(metric=metric)
    before = tf.flash_rerank.launches
    got = tf.flash_rerank(minima, q, x, 10, metric, tile=256, n_valid=n_valid)
    want = tf._flash_rerank_plain(minima, q, x, 10, metric, tile=256,
                                  shortlist=20, n_valid=n_valid)
    assert tf.flash_rerank.launches == before
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64


def _bad_rerank_args(which):
    minima, q, x = _rerank_inputs(seed=9)
    args = dict(minima=minima, q=q, x_f32=x, k=10, metric="l2", tile=256,
                buckets=128, shortlist=0, n_valid=None)
    if which == "metric":
        args["metric"] = "cosine"
    elif which == "q_f64":
        args["q"] = q.double()
    elif which == "x_bf16":
        args["x_f32"] = x.to(torch.bfloat16)
    elif which == "q_strided":
        args["q"] = torch.cat([q, q], 1)[:, ::2]
    elif which == "minima_2d":
        args["minima"] = minima[0]
    elif which == "batch":
        args["q"] = q[:-1].contiguous()
    elif which == "width":
        args["x_f32"] = x[:, :-1].contiguous()
    elif which == "buckets":
        args["buckets"] = 64
    elif which == "shortlist":
        args["shortlist"] = minima.shape[0] * 128 + 1
    elif which == "k":
        args["k"], args["shortlist"] = 2 * 3 + 1, 3    # past 3 groups' rows
    elif which == "n_valid":
        args["n_valid"] = -1
    elif which == "no_rows":
        args["x_f32"] = x[:0]
    return args


@pytest.mark.parametrize("which,error", [
    ("metric", ValueError), ("q_f64", TypeError), ("x_bf16", TypeError),
    ("q_strided", ValueError), ("minima_2d", ValueError),
    ("batch", ValueError), ("width", ValueError), ("buckets", ValueError),
    ("shortlist", ValueError), ("k", ValueError), ("n_valid", ValueError),
    ("no_rows", ValueError)])
def test_flash_rerank_checks_inputs(which, error):
    args = _bad_rerank_args(which)
    with pytest.raises(error):
        tf.flash_rerank(**args)


def test_flash_rerank_has_no_fallback_off_cpu():
    """Only a CPU tensor takes the plain version; another device never falls
    back to it (a CUDA tensor launches the kernel or raises)."""
    minima, q, x = _rerank_inputs(seed=10)
    before = tf.flash_rerank.launches
    with pytest.raises(ValueError, match="no kernel"):
        tf.flash_rerank(minima.to("meta"), q.to("meta"), x.to("meta"), 10,
                        "l2", tile=256)
    assert tf.flash_rerank.launches == before


def test_rerank_source_exports_what_the_wrapper_binds():
    """Nothing compiles on the CPU: read the re-rank kernel's source and
    check that its extern "C" block exports exactly the three functions
    `_rerank_launcher` binds, with as many arguments as their ctypes
    signatures, and that it is one design with no switch."""
    import ctypes
    import os
    import re
    from databend_tpu_torch.ops import _cuda
    with open(os.path.join(_cuda.CSRC_DIR, "flash_rerank.cu")) as f:
        src = f.read()
    assert src.count('extern "C" {') == 1
    block = re.sub(r"//[^\n]*", "", src[src.index('extern "C" {'):])
    exported = {name: [a for a in args.split(",") if a.strip()]
                for name, args in re.findall(
                    r"^\w[^\n(]*?\b(\w+)\s*\(([^)]*)\)\s*\{", block, re.M)}
    assert set(exported) == {"flash_rerank_launch",
                             "flash_rerank_scratch_words",
                             "flash_rerank_error_string"}
    args = exported["flash_rerank_launch"]
    assert len(args) == len(tf._RERANK_ARGTYPES) == 19
    for arg, ctype in zip(args, tf._RERANK_ARGTYPES):
        assert ("*" in arg) == (ctype is ctypes.c_void_p), arg
        if ctype is ctypes.c_longlong:
            assert "long long" in arg, arg
    assert len(exported["flash_rerank_scratch_words"]) == 4
    assert len(exported["flash_rerank_error_string"]) == 1
    # the symbol the benchmark counts chunks by, and a library call, are
    # not in it
    for needle in ("flash_group_minima_kernel", "getenv", "cub::", "thrust"):
        assert needle not in src
