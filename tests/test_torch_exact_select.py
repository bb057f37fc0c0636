"""The exact-KNN selection of the port against the JAX package, on the CPU.

``ops.exact_topk.exact_topk_select`` turns the product block into
distances, masks the pad columns and the cells a filter drops, and takes the
k smallest per query in ``jax.lax.top_k(-d, k)``'s order. On CPU tensors it
runs its plain version (``finish_distance``, the masks and
``ops.topk.topk_smallest_lowest_index``); the CUDA kernel beside it
(``csrc/exact_topk_select.cu``) is held to that plain version on the card by
``chip_smoke.py``, ids equal and values bit-equal.

The data are integers (and rows of a power-of-two norm under cosine), so
every distance is exact in f32 in both packages: ids are held equal to the
JAX package's at every rank, ties by the hundred included, and values
bit-equal. The split of ``pairwise_distance`` into ``pairwise_product`` and
``finish_distance`` is held bit-equal to the composition it replaced.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from databend_tpu.ops import distance as jdist
from databend_tpu.ops import topk as jtopk
from databend_tpu.service import prepared as jprep
from databend_tpu.storage.fuse import table as jtable

from databend_tpu_torch import backend
from databend_tpu_torch.ops import distance as tdist
from databend_tpu_torch.ops import exact_topk as ex
from databend_tpu_torch.ops import topk as ttopk
from databend_tpu_torch.service import prepared as tprep
from databend_tpu_torch.storage.fuse import table as ttable

N, D, B = 600, 8, 6


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(0, 4, shape).astype(
        np.float32)


def _pow2_rows(seed, n):
    """Integer rows in [0, 3] of squared norm 1, 4 or 16, normalised: their
    cosines are exact in f32."""
    pool = _ints(seed, (4000, D))
    pool = pool[np.isin((pool ** 2).sum(1), (1, 4, 16))]
    rows = pool[np.random.default_rng(seed).integers(0, len(pool), n)]
    return rows / np.sqrt((rows ** 2).sum(1, keepdims=True))


def _data(metric, seed=3):
    """(queries [B, D], corpus [N, D]) for ``metric``, ties at every rank."""
    if metric == "cosine":
        return _pow2_rows(seed, B), _pow2_rows(seed + 1, N)
    return _ints(seed, (B, D)), _ints(seed + 1, (N, D))


def _same(got, want):
    gv, gi = (np.asarray(t) for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi.astype(np.int64), wi.astype(np.int64))
    assert gv.astype(np.float32).tobytes() == wv.astype(np.float32).tobytes()


# ------------------------------------------------ product and epilogue
def _composed(q, x, metric, dtype, norms, normalized):
    """``pairwise_distance`` as it was composed before the split."""
    if metric == "cosine":
        qn = tdist.normalize(q)
        xn = x if normalized else tdist.normalize(x)
        return 1.0 - tdist._dot(qn, xn, dtype)
    if metric == "ip":
        return -tdist._dot(q, x, dtype)
    q32 = q.float()
    qq = torch.sum(q32 * q32, dim=-1, keepdim=True)
    if norms is None:
        norms = torch.sum(x.float() * x.float(), dim=-1)
    d = torch.clamp_min(qq - 2.0 * tdist._dot(q, x, dtype) + norms[None, :],
                        0.0)
    return torch.sqrt(d) if metric == "l2" else d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "l2_sq", "cosine", "ip"])
@pytest.mark.parametrize("given", [False, True])
def test_product_then_epilogue_is_pairwise_distance(metric, dtype, given):
    """Bit-equal to the composition it replaced and to ``pairwise_distance``
    (Gaussian rows: the split must not reorder a rounding), with the norms
    or the normalised corpus given or not; and within rtol 1e-5 of the
    JAX package's distances (its dot adds in another order)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((5, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((300, 24)).astype(np.float32))
    norms = torch.sum(x * x, -1) if given and metric != "cosine" else None
    normalized = given and metric == "cosine"
    if normalized:
        x = tdist.normalize(x)
    got = tdist.finish_distance(*tdist.pairwise_product(
        q, x, metric, dtype, norms, normalized), metric)
    want = _composed(q, x, metric, dtype, norms, normalized)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert got.numpy().tobytes() == tdist.pairwise_distance(
        q, x, metric, dtype, norms, normalized).numpy().tobytes()
    jd = jdist.pairwise_distance(
        jnp.asarray(q.numpy()), jnp.asarray(x.numpy()), metric,
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
        None if norms is None else jnp.asarray(norms.numpy()),
        x_normalized=normalized)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


def test_product_has_no_l1_form():
    q = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        tdist.pairwise_product(q, q, "l1")
    with pytest.raises(ValueError):
        tdist.finish_distance(q, None, None, "l1")


# --------------------------------------------------- the plain version
def _operands(metric, seed=3):
    q, x = _data(metric, seed)
    qx, qq, xx = tdist.pairwise_product(torch.from_numpy(q),
                                        torch.from_numpy(x), metric,
                                        x_normalized=metric == "cosine")
    return q, x, qx, qq, xx


def _lax_select(d, k, n_valid=None, keep=None):
    """The reference's selection: masks by index, then lax.top_k(-d, k)."""
    d = np.array(d, np.float32)
    if n_valid is not None:
        d[:, n_valid:] = np.inf
    if keep is not None:
        d = np.where(keep, d, np.float32(np.inf))
    nv, ids = jax.lax.top_k(-jnp.asarray(d), k)
    return -np.asarray(nv), np.asarray(ids)


CASES = {           # name -> (k, n_valid, keep)
    "k1": (1, None, False), "k10": (10, None, False),
    "k128": (128, None, False), "pads": (10, 530, False),
    "k past the valid rows": (10, 4, False), "keep": (10, None, True),
    "keep and pads": (128, 300, True), "no valid row": (5, 0, False)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("metric", ["l2", "l2_sq", "cosine", "ip"])
def test_plain_select_is_lax_top_k(metric, case):
    """On tied integer distances: the plain version equals ``lax.top_k``
    over the same distances, masked the reference's way."""
    k, n_valid, with_keep = CASES[case]
    _, _, qx, qq, xx = _operands(metric)
    keep = torch.from_numpy(np.random.default_rng(5).random((B, N)) < 0.3) \
        if with_keep else None
    got = ex.exact_topk_select(qx, qq, xx, metric, k, n_valid, keep)
    d = tdist.finish_distance(qx, qq, xx, metric).numpy()
    _same(got, _lax_select(d, k, n_valid,
                           None if keep is None else keep.numpy()))
    assert ex.exact_topk_select.launches == 0        # the CPU: plain


def test_plain_select_orders_signed_zeros_as_lax_top_k():
    """ip distances ``-qx`` of both signs of zero: the reference ranks +0.0
    before -0.0 (``lax.top_k`` over ``-d``), and so must the key order."""
    rng = np.random.default_rng(9)
    qx = np.where(rng.random((B, N)) < 0.5, np.float32(0.0),
                  np.float32(-0.0)).astype(np.float32)
    qx[:, ::7] = rng.integers(-2, 3, qx[:, ::7].shape)
    got = ex.exact_topk_select(torch.from_numpy(qx), None, None, "ip", 300)
    want = _lax_select(-qx, 300)
    zeros = want[0] == 0.0
    assert np.signbit(want[0][zeros]).any() and (~np.signbit(
        want[0][zeros])).any()
    _same(got, want)


def test_plain_select_takes_a_filter_row_for_every_query():
    """``keep`` of one row applies to every query."""
    _, _, qx, qq, xx = _operands("l2")
    row = torch.from_numpy(np.random.default_rng(2).random((1, N)) < 0.5)
    got = ex.exact_topk_select(qx, qq, xx, "l2", 10, keep=row)
    want = ex.exact_topk_select(qx, qq, xx, "l2", 10,
                                keep=row.expand(B, -1).contiguous())
    _same(got, want)


# ------------------------------------------------------ the call sites
@pytest.mark.parametrize("k,n_valid", [(1, None), (10, None), (128, None),
                                       (10, 550), (10, 6)])
@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_exact_program_matches_the_jax_program(metric, k, n_valid):
    """``storage.fuse.table._exact_topk_program`` (the literal statement's
    scan and ``_scan_topk_program``'s) against the JAX package's: ids
    equal, values bit-equal (the l2 re-score too)."""
    q, x = _data(metric)
    want = jtable._exact_topk_program(q, jnp.asarray(x), k, metric, n_valid)
    got = ttable._exact_topk_program(q, torch.from_numpy(x), k, metric,
                                     n_valid)
    _same(got, want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_program_matches_the_jax_program(metric):
    """``service.prepared._scan_topk_program`` at B = 300 (two query
    chunks in the port) against the reference's one-chunk scan."""
    q, x = _ints(7, (300, D)), _ints(8, (N, D))
    run = jprep._scan_topk_program(10, metric, 1, 300, True)
    want = run(jnp.asarray(q), jnp.asarray(x), jnp.int32(590))
    got = tprep._scan_topk_program(torch.from_numpy(q), torch.from_numpy(x),
                                   10, metric, 590)
    _same(got, want)


@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_filtered_program_matches_the_jax_program(metric, k):
    """``service.prepared._scan_topk_filtered_program``: a static row mask
    and a per-query ``price < ?`` composed into ``keep``; queries that
    match fewer than k rows keep their +inf tail, in position order."""
    q, x = _ints(7, (B, D)), _ints(8, (N, D))
    rng = np.random.default_rng(4)
    smask = rng.random(N) < 0.8
    price = rng.integers(0, 100, N).astype(np.int64)
    bounds = np.array([1, 2, 50, 90, 100, 0], np.int64)
    run = jprep._scan_topk_filtered_program(k, metric, 1, B, True, ("<",))
    want = run(jnp.asarray(q), jnp.asarray(x), jnp.int32(580),
               jnp.asarray(smask), (jnp.asarray(price),),
               (jnp.asarray(bounds),))
    got = tprep._scan_topk_filtered_program(
        torch.from_numpy(q), torch.from_numpy(x), k, metric, 580,
        torch.from_numpy(smask), (torch.from_numpy(price),),
        (torch.from_numpy(bounds),), ("<",))
    assert np.isinf(np.asarray(want[0])).any()
    _same(got, want)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("chunk_rows,n_valid", [(128, None), (128, 1450),
                                                (128, 1003), (1000, 1300)])
@pytest.mark.parametrize("metric,dtype", [("l2", "f32"), ("ip", "f32"),
                                          ("l2", "bf16")])
def test_chunked_topk_matches_the_jax_scan(metric, dtype, chunk_rows,
                                           n_valid, k):
    """``ops.topk.chunked_topk_smallest`` (configuration 5's shards, the
    HNSW build's kNN graph) against the reference's scan: chunks of 128
    with a ragged tail of 88 rows, or one chunk; global ids from base_id
    1000; pads in a middle chunk, a valid set smaller than k, all rows
    valid. Integers in [0, 3] are exact in bf16 too."""
    q, x = _ints(12, (B, D)), _ints(13, (N, D))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" \
        else (jnp.float32, torch.float32)
    want = jtopk.chunked_topk_smallest(
        jnp.asarray(q), jnp.asarray(x), k, metric, chunk_rows, jd,
        base_id=1000, n_valid=None if n_valid is None else jnp.int32(n_valid))
    got = ttopk.chunked_topk_smallest(
        torch.from_numpy(q), torch.from_numpy(x), k, metric, chunk_rows, td,
        base_id=1000, n_valid=n_valid)
    _same(got, want)


# ------------------------------------------------ the kernel's selection
def _keys(d: torch.Tensor) -> list:
    """The kernel's u64 keys (ord(-d) << 32) | (0xffffffff - i), as Python
    ints; 0 is the empty key."""
    bits = (-d).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | 1 << 31)
    return [[(hi << 32) | (0xFFFFFFFF - i) for i, hi in enumerate(row)]
            for row in ordered.tolist()]


def _unkey(keys):
    hi = np.array([k >> 32 for k in keys], np.uint32)
    bits = np.where(hi >= 1 << 31, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    return -bits.view(np.float32), [0xFFFFFFFF - (k & 0xFFFFFFFF)
                                    for k in keys]


def _cap(k):
    return 32 * (2 if k <= 32 else 4 if k <= 96 else 8)


class _Warp:
    """A warp's buffer and threshold (csrc offer<R>): fed a ballot of 32
    keys (0: none) at a time; a ballot that would overflow cuts the buffer
    to its k largest first, the threshold rises to the k-th and the
    query's shared threshold (``shared``, one value, or None) to at least
    that."""

    def __init__(self, k, shared=None):
        self.k, self.cap, self.shared = k, _cap(k), shared
        self.buf, self.thr = [], 0

    def offer(self, lanes):
        if not any(x > self.thr for x in lanes):
            return
        if len(self.buf) + sum(x > self.thr for x in lanes) > self.cap:
            self.buf = sorted(self.buf, reverse=True)[:self.k]
            assert len(self.buf) == self.k
            self.thr = max(self.thr, self.buf[-1])
            if self.shared is not None:
                self.shared[0] = max(self.shared[0], self.thr)
        self.buf += [x for x in lanes if x > self.thr]
        assert len(self.buf) <= self.cap

    def top(self):
        self.buf = sorted(self.buf, reverse=True)[:self.k]
        return self.buf


def _select_like_the_kernel(d, k, strip, order, unroll=2, warps=8):
    """Phase one: each query's positions in strips of ``strip``, a warp
    each; an iteration reads ``32 * 4 * unroll`` positions (lane l's four
    at 4 (u * 32 + l)), takes the query's shared threshold, and offers the
    keys of load u, position e, as one ballot of the 32 lanes. The warps
    of a query take iterations in ``order`` ("turns": one iteration each
    in turn, "reverse": the last strip first, whole). Phase two as
    csrc merge_kernel: 8 warps offer the strips' top k in turns, warp 0
    takes the others'."""
    step = 32 * 4 * unroll
    out = []
    for row in _keys(d):
        n = len(row)
        shared = [0]
        strips = list(range(0, n, strip))
        ws = [_Warp(k, shared) for _ in strips]
        iters = [list(range(lo, min(n, lo + strip), step)) for lo in strips]

        def run(w, lo, base):
            end = min(n, lo + strip)
            w.thr = max(w.thr, shared[0])
            for u in range(unroll):
                for e in range(4):
                    lanes = []
                    for lane in range(32):
                        i = base + 4 * (u * 32 + lane) + e
                        lanes.append(row[i] if i < end else 0)
                    w.offer(lanes)

        if order == "turns":
            for it in range(max(len(x) for x in iters)):
                for w, lo, its in zip(ws, strips, iters):
                    if it < len(its):
                        run(w, lo, its[it])
        else:
            for w, lo, its in reversed(list(zip(ws, strips, iters))):
                for base in its:
                    run(w, lo, base)
        part = []
        for w in ws:
            top = w.top()
            part += top + [0] * (k - len(top))
        mw = [_Warp(k) for _ in range(warps)]
        for wi, w in enumerate(mw):
            for base in range(wi * 32, len(part), warps * 32):
                w.offer(part[base:base + 32] + [0] * max(0, base + 32
                                                         - len(part)))
        lead = mw[0]
        lead.top()
        lead.thr = lead.buf[-1] if len(lead.buf) == k else 0
        for w in mw[1:]:
            top = w.top()
            for j in range(0, len(top), 32):
                chunk = top[j:j + 32]
                lead.offer(chunk + [0] * (32 - len(chunk)))
        out.append(lead.top())
    return out


@pytest.mark.parametrize("k,strip,order", [
    (1, 256, "turns"), (10, 256, "turns"), (10, 512, "reverse"),
    (32, 1536, "turns"), (40, 256, "reverse"), (128, 256, "turns"),
    (128, 2048, "reverse"), (96, 768, "turns")])
def test_strip_then_merge_selection_is_the_tie_rule_top_k(k, strip, order):
    """The kernel's algorithm in Python: u64 keys, a buffer and a threshold
    a warp, a threshold per query the warps share, strips taken in two
    orders, a ragged last strip, then the merge of the strips' top k. It
    equals ``topk_smallest_lowest_index`` on the same distances: both
    zeros, +inf runs (the masked cells), ties by the hundred, and
    distances falling with the position (each position enters the top k:
    the most cuts)."""
    rng = np.random.default_rng(k + strip)
    n = 1900
    pool = np.array([0.0, -0.0, 1.5, 2.5, 3.0, np.inf], np.float32)
    d = pool[rng.integers(0, len(pool), (4, n))]
    d[1] = np.linspace(2.0, 0.0, n, dtype=np.float32)
    d[1, ::9] = 0.25
    d[2, 200:1700] = np.inf
    d[3] = np.abs(rng.standard_normal(n)).astype(np.float32)
    dt = torch.from_numpy(d)
    wv, wi = ttopk.topk_smallest_lowest_index(dt, k)
    for q, keys in enumerate(_select_like_the_kernel(dt, k, strip, order)):
        gv, gi = _unkey(keys)
        assert gi == wi[q].tolist()
        assert gv.tobytes() == wv[q].numpy().tobytes()


class _Block:
    """A block's buffer and threshold (csrc BlockShared): keys at or above
    the threshold are appended; a round that leaves more than ``cut_at``
    keys cuts (csrc block_kernel: min(CUT_AT, CUT_K * k)); a cut is
    block_cut's radix select."""

    CUT_AT, CUT_K = ex.ROUND, 8      # csrc constants

    def __init__(self, k):
        self.k, self.buf, self.thr, self.cuts = k, [], 0, 0
        self.cut_at = min(self.CUT_AT, self.CUT_K * k)

    def append(self, keys, thr):
        self.buf += [x for x in keys if x and x >= thr]
        assert len(self.buf) <= 2 * ex.ROUND          # csrc BUF

    def cut(self):
        """block_cut: 8-bit digits from the top; a pass counts the digits
        of the keys sharing the prefix, takes the digit whose bucket holds
        the k-th key by a suffix sum, and stops once that bucket is wholly
        among the k; the keys whose top bits are at or above the prefix are
        then exactly the k."""
        prefix = pmask = 0
        need = self.k
        for shift in range(56, -8, -8):
            hist = [0] * 256
            for x in self.buf:
                if x & pmask == prefix:
                    hist[(x >> shift) & 0xFF] += 1
            suf = 0
            for digit in range(255, -1, -1):
                if suf + hist[digit] >= need:
                    break
                suf += hist[digit]
            need -= suf
            prefix |= digit << shift
            pmask |= 0xFF << shift
            if hist[digit] == need:
                break
        sel = [x for x in self.buf if x & pmask >= prefix]
        assert len(sel) == self.k
        self.buf, self.thr = sel, max(self.thr, min(sel))
        self.cuts += 1


def _select_like_the_blocks(d, k, ways, order):
    """BLOCKS (csrc block_kernel) in Python: each query's positions in
    ``ways`` segments of a multiple of ROUND, a block each; a round reads
    ROUND positions, warp w's 256 at w * 256 (lane l's four of load u at 4
    (u * 32 + l)), every key at or above max(the block's threshold, the
    query's) appended, and a round that leaves more than CUT_AT keys cuts
    and raises the query's threshold. The blocks of a query take rounds in
    ``order`` ("turns": one round each in turn; "reverse": the last
    segment first, whole). Each block cuts to its k largest at the end and
    publishes them; the block that finishes last merges the lists, keys at
    or above the query's threshold, ROUND entries a round, with the same
    append and cut, and ranks its k keys (a sort: the keys are distinct).
    Returns (each query's keys in rank order, the cuts)."""
    seg = -(-(-(-d.shape[1] // ways)) // ex.ROUND) * ex.ROUND
    out, cuts = [], 0
    for row in _keys(d):
        n = len(row)
        spans = [(lo, min(n, lo + seg)) for lo in range(0, n, seg)]
        shared = [0]
        blocks = [_Block(k) for _ in spans]

        def run(blk, lo, end, base):
            thr = max(blk.thr, shared[0])
            for w in range(8):
                for u in range(2):
                    for lane in range(32):
                        i = base + w * 256 + 4 * (u * 32 + lane)
                        blk.append([row[j] for j in range(i, i + 4)
                                    if j < end], thr)
            if len(blk.buf) > blk.cut_at:
                blk.cut()
                shared[0] = max(shared[0], blk.thr)

        rounds = [list(range(lo, end, ex.ROUND)) for lo, end in spans]
        done = []
        if order == "turns":
            for r in range(max(len(x) for x in rounds)):
                for g, (lo, end) in enumerate(spans):
                    if r < len(rounds[g]):
                        run(blocks[g], lo, end, rounds[g][r])
                        if r == len(rounds[g]) - 1:
                            done.append(g)
        else:
            for g in reversed(range(len(spans))):
                for base in rounds[g]:
                    run(blocks[g], *spans[g], base)
                done.append(g)
        lists = []
        for g in done:
            blk = blocks[g]
            if len(blk.buf) > k:
                blk.cut()
                shared[0] = max(shared[0], blk.thr)
            lists.append(blk.buf)
        last = blocks[done[-1]]
        if ways > 1:
            thr = max(last.thr, shared[0])
            entries = [x for g in range(len(spans)) for x in
                       blocks[g].buf + [0] * (k - len(blocks[g].buf))]
            merge = _Block(k)
            for e0 in range(0, len(entries), ex.ROUND):
                merge.append(entries[e0:e0 + ex.ROUND], thr)
                if len(merge.buf) > merge.cut_at:
                    merge.cut()
            if len(merge.buf) > k:
                merge.cut()
            last = merge
        assert len(last.buf) == k
        cuts += sum(b.cuts for b in blocks) + last.cuts * (ways > 1)
        out.append(sorted(last.buf, reverse=True))
    return out, cuts


def _tie_rule_rows(seed, n):
    """Rows of distances for the selection models: tie-heavy values with
    both zeros and +inf (the masked cells), distances falling with the
    position (each position enters the top k: the most cuts) with ties
    every ninth, a run of +inf, and |normal| values."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1.5, 2.5, 3.0, np.inf], np.float32)
    d = pool[rng.integers(0, len(pool), (4, n))]
    d[1] = np.linspace(2.0, 0.0, n, dtype=np.float32)
    d[1, ::9] = 0.25
    d[2, n // 9:n - n // 9] = np.inf
    d[3] = np.abs(rng.standard_normal(n)).astype(np.float32)
    return torch.from_numpy(d)


@pytest.mark.parametrize("order", ["turns", "reverse"])
@pytest.mark.parametrize("ways", [1, 3])
@pytest.mark.parametrize("k", [1, 32, 33, 101, 128])
def test_block_selection_is_the_tie_rule_top_k(k, ways, order):
    """BLOCKS' algorithm in Python (_select_like_the_blocks): rounds of
    appends at or above the threshold, radix-select cuts, the query's
    shared threshold, the last block's merge of the segments' lists. Rows
    of 9,000 positions: five rounds a block at ways = 1, a ragged last
    segment at ways = 3. It equals ``topk_smallest_lowest_index`` on tied,
    signed-zero, +inf and descending rows, and it cuts."""
    dt = _tie_rule_rows(k + ways, 9000)
    wv, wi = ttopk.topk_smallest_lowest_index(dt, k)
    got, cuts = _select_like_the_blocks(dt, k, ways, order)
    for q, keys in enumerate(got):
        gv, gi = _unkey(keys)
        assert gi == wi[q].tolist()
        assert gv.tobytes() == wv[q].numpy().tobytes()
    assert cuts > 0


@pytest.mark.parametrize("k", [1, 32, 33, 101, 128])
def test_radix_cut_keeps_the_k_largest_keys(k):
    """block_cut alone on buffers of distinct keys that share their top 32
    bits (ties: only the position bits differ), that differ in the top
    byte, and that are random: exactly the k largest stay, and the
    threshold becomes the least of them."""
    rng = np.random.default_rng(k)
    pos = rng.permutation(1 << 20)[:3000]
    tied = [(0xBF800000 << 32) | (0xFFFFFFFF - int(i)) for i in pos]
    spread = [(int(h) << 32) | (0xFFFFFFFF - int(i)) for h, i in
              zip(rng.integers(1, 1 << 32, 3000), pos)]
    top = [(int(h) << 56) | int(i) for h, i in
           zip(rng.permutation(255)[:200] + 1, pos)]
    for keys in (tied, spread, top + tied[:50]):
        blk = _Block(k)
        blk.buf = list(keys)
        blk.cut()
        assert sorted(blk.buf) == sorted(keys)[-k:]
        assert blk.thr == sorted(keys)[-k]


def _round_up_f32(x64):
    """float64 values rounded up to float32 (csrc __fmul_ru of two f32: the
    product is exact in f64)."""
    f = x64.astype(np.float32)
    return np.where(f.astype(np.float64) < x64,
                    np.nextafter(f, np.float32(np.inf)), f)


def _coarse_bound(d, metric):
    """csrc coarse_bound: the largest coarse value that may still pass the
    k-th distance ``d``; l2 squares the next float up, rounded up."""
    if metric != "l2":
        return d
    up = np.nextafter(d, np.float32(np.inf))
    return _round_up_f32(up.astype(np.float64) ** 2)


@pytest.mark.parametrize("metric", ["l2", "l2_sq", "cosine", "ip"])
def test_coarse_filter_drops_no_cell_that_can_pass(metric):
    """The kernel's stream keeps a cell only where its coarse value (l2 and
    l2_sq: (qq - 2 qx) + xx before the clamp and the square root; cosine
    and ip: the distance) is at most ``coarse_bound`` of the threshold's
    distance. Every cell whose distance is at most that distance (ties
    included, both zeros, tiny and huge values) must be kept, so the filter
    never changes the selection."""
    rng = np.random.default_rng(21)
    mags = np.concatenate([rng.random(4000) * 10.0 ** rng.integers(-40, 38,
                                                                   4000),
                           [0.0, 1e-45, 2e-45, 1.0, 4.0, 3.4e38]])
    t = np.concatenate([mags, -mags, rng.integers(0, 50, 2000)]).astype(
        np.float32)
    if metric in ("l2", "l2_sq"):
        coarse = t
        d = np.maximum(t, np.float32(0))
        d = np.sqrt(d) if metric == "l2" else d
    else:
        coarse = d = t
    with np.errstate(over="ignore"):
        for kth in rng.choice(d, 300):
            bound = _coarse_bound(np.float32(kth), metric)
            may_pass = d <= kth
            assert (coarse[may_pass] <= bound).all()


# --------------------------------------------------------- the plan
@pytest.mark.parametrize("b,n,want", [
    (256, 1_000_000, (501_760, 2)),     # the serving chunk
    (8, 131_072, (8_192, 16)),          # [mesh]'s chunk
    (1_024, 65_536, (65_536, 1)),       # the HNSW build's batch
    (1, 1_000_000, (8_192, 123)),       # a literal statement's one query
    (300, 5_000, (6_144, 1)),
    (6, 600, (2_048, 1)),
    (132, 1_000_000, (251_904, 4)),
    (529, 1_000_000, (1_001_472, 1)),
    (1_024, 1_000_000, (1_001_472, 1)),  # a B = 1,024 batch's chunk
    (64, 65_536, (8_192, 8)),
    (8, 1_000_000, (16_384, 62)),
    (1, 8_193, (6_144, 2))])
def test_plan_fills_the_card(b, n, want):
    """Segments of whole rounds that cover a row;
    as many a query as keep b x ways within the blocks an H100 holds at once
    (one wave), never shorter than MIN_SEGMENT, at least one; a scratch of
    a few MB, none for one segment a query."""
    p = ex._plan(b, n)
    assert (p.span, p.ways) == want
    assert p.span % ex.ROUND == 0
    assert (p.ways - 1) * p.span < n <= p.ways * p.span
    assert p.ways <= max(1, -(-n // ex.MIN_SEGMENT))
    assert p.ways == 1 or b * p.ways <= ex.SMS * ex.BLOCKS_A_SM
    ex._check_plan(p, b, n)
    words = ex._scratch_words(p, b, ex.MAX_K)
    assert words == (0 if p.ways == 1 else b * (p.ways * (ex.MAX_K + 1) + 2))
    assert words * 8 < 64 << 20


# ------------------------------------------------------------ the wrapper
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, qx, qq, xx = _operands("l2")
    with pytest.raises(TypeError):
        ex.exact_topk_select(qx.double(), qq, xx, "l2", 5)
    with pytest.raises(ValueError):
        ex.exact_topk_select(qx.T, qq, xx, "l2", 5)          # not contiguous
    for k in (0, N + 1):
        with pytest.raises(ValueError):
            ex.exact_topk_select(qx, qq, xx, "l2", k)
    with pytest.raises(ValueError):
        ex.exact_topk_select(qx, None, xx, "l2", 5)          # no qq
    with pytest.raises(ValueError):
        ex.exact_topk_select(qx, qq, xx[:-1], "l2_sq", 5)
    with pytest.raises(ValueError):
        ex.exact_topk_select(qx, qq, xx, "l1", 5)
    with pytest.raises(ValueError):
        ex.exact_topk_select(qx, qq, xx, "l2", 5, n_valid=-1)
    for keep in (torch.ones(B, N, dtype=torch.uint8),
                 torch.ones(2, N, dtype=torch.bool),
                 torch.ones(B, N + 1, dtype=torch.bool)):
        with pytest.raises(ValueError):
            ex.exact_topk_select(qx, qq, xx, "l2", 5, keep=keep)
    wide = torch.empty((1, 1 << 32), device="meta")
    with pytest.raises(ValueError):
        ex.exact_topk_select(wide, None, None, "ip", 5)
    # plans the C launcher refuses: a segment that is not whole rounds or
    # not positive, ways that do not cover the row or cover it more than
    # once, a grid past 2^31 blocks
    block = torch.empty((B, 10_000), device="meta")
    for plan in (ex.Plan(ex.STEP * 3, 14),
                 ex.Plan(ex.ROUND + 1, 5),
                 ex.Plan(0, 1),
                 ex.Plan(2 * ex.ROUND, 2),
                 ex.Plan(ex.ROUND, 100)):
        with pytest.raises(ValueError, match="no kernel plan"):
            ex._launch(None, block, None, None, "ip", 5, None, None, plan)
    with pytest.raises(ValueError, match="no kernel plan"):
        ex._launch(None, torch.empty((1 << 22, 1 << 20), device="meta"),
                   None, None, "ip", 5, None, None,
                   ex.Plan(ex.ROUND, (1 << 20) // ex.ROUND))
    assert ex.exact_topk_select.launches == 0


class _Fn:
    """A C function of a fake build: returns ``value``."""

    def __init__(self, value):
        self.value, self.argtypes = value, None

    def __call__(self, *args):
        return self.value


def test_bind_checks_the_constants_the_plan_shares_with_the_source():
    """``_bind`` sets the signatures of a build and refuses one whose
    MAX_K or ROUND differ from this module's (the plan's segments are whole
    rounds)."""
    for name in ex._HANDSHAKE:
        lib = type("Lib", (), {})()
        for fn in ("exact_topk_select_launch", "exact_topk_select_empty",
                   "exact_topk_select_error_string"):
            setattr(lib, fn, _Fn(0))
        for other, value in ex._HANDSHAKE.items():
            setattr(lib, other, _Fn(value))
        assert ex._bind(lib) is lib
        assert lib.exact_topk_select_launch.argtypes == ex._LAUNCH_ARGTYPES
        setattr(lib, name, _Fn(ex._HANDSHAKE[name] * 2))
        with pytest.raises(RuntimeError, match=name):
            ex._bind(lib)


def test_wrapper_routes_large_k_to_the_composition():
    """Off the CPU, k above MAX_K runs the masked distances and the tie-rule
    top-k (here on the meta device, which has no kernel: k <= MAX_K
    raises there instead of running anything else)."""
    qx = torch.empty((B, 4096), device="meta")
    vals, pos = ex.exact_topk_select(qx, None, None, "ip", ex.MAX_K + 1,
                                     n_valid=100)
    assert vals.shape == pos.shape == (B, ex.MAX_K + 1)
    with pytest.raises(ValueError, match="no kernel"):
        ex.exact_topk_select(qx, None, None, "ip", ex.MAX_K)
    assert ex.exact_topk_select.launches == 0


@pytest.mark.parametrize("metric", ["l2", "l2_sq", "cosine", "ip", "l1"])
def test_exact_topk_is_product_and_select(metric):
    """``exact_topk`` equals the masked ``pairwise_distance`` and the
    tie-rule top-k for every metric; l1 (no product form) takes that route
    itself."""
    q, x = (torch.from_numpy(a) for a in _data(metric))
    keep = torch.from_numpy(np.random.default_rng(8).random((B, N)) < 0.5)
    got = ex.exact_topk(q, x, 20, metric, n_valid=590, keep=keep,
                        x_normalized=metric == "cosine")
    d = tdist.pairwise_distance(q, x, metric, x_normalized=metric == "cosine")
    d[:, 590:] = float("inf")
    d.masked_fill_(~keep, float("inf"))
    _same(got, ttopk.topk_smallest_lowest_index(d, 20))
