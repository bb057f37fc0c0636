"""The selecting impact BM25 scorer of the port against the JAX package, on
the CPU.

``impact_bm25_topk`` computes what the reference's ``_impact_topk_program``
and ``_impact_fused_topk_program`` compute, their final ``jax.lax.top_k``
included. On CPU tensors it runs its plain version, the plain scores and
``topk_largest_lowest_index``; the CUDA kernel beside it is held to that
plain version on the card by ``chip_smoke.py``.

Tolerances. Ids are compared exactly. The port adds the products of a doc's
terms in term order without fused multiply-adds, so its values are held
bit-equal to the same formula in numpy; XLA's CPU dot in the reference's
einsum fuses them, so against the JAX programs values agree to rtol 1e-6
(text) and, where the distance product is summed in another order, to rtol
1e-5 and atol 1e-6 (fused).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.index.inverted import device as jdev

from databend_tpu_torch import backend
from databend_tpu_torch.index.inverted import device as tdev
from databend_tpu_torch.ops import impact_bm25
from databend_tpu_torch.ops.topk import topk_largest_lowest_index

N_PAD = 512
TILE = 256          # the reference program's doc tile


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


def _operands(seed, n_docs, slots=8, b=6, m=4, g=4, tie=False):
    """A block's layout and a query batch in the scorer's contract (a term
    at most once per doc, pad docs and slots -2, pad terms -1 after the real
    ones, a group's terms adjacent), plus the one-hot group matrix the
    reference takes. Query 0 is all pad; query 1 asks for one rare term
    (three docs hold it, none when every doc ties); odd queries are AND."""
    rng = np.random.default_rng(seed)
    vocab = 2 * slots + 1
    term_ids = np.full((N_PAD, slots), -2, np.int32)
    sat = np.zeros((N_PAD, slots), np.float32)
    for d in range(n_docs):
        cnt = int(rng.integers(1, slots + 1))
        term_ids[d, :cnt] = np.sort(rng.choice(vocab - 1, cnt, replace=False))
        sat[d, :cnt] = rng.uniform(0.5, 2.0, cnt)
    rare = vocab - 1
    if tie:                         # every doc the same terms, same weights
        term_ids[:n_docs] = term_ids[0]
        sat[:n_docs] = sat[0]
    else:
        term_ids[[3, 77, 400], 0] = rare
    words = term_ids[0][term_ids[0] >= 0] if tie else np.arange(vocab - 1)
    qterms = np.full((b, m), -1, np.int32)
    idf = np.zeros((b, m), np.float32)
    qgroup = np.full((b, m), -1, np.int32)
    need = np.ones(b, np.float32)
    for q in range(1, b):
        n_terms = 1 if q == 1 else int(rng.integers(1, m + 1))
        qterms[q, :n_terms] = rare if q == 1 else rng.choice(words, n_terms)
        idf[q, :n_terms] = rng.uniform(0.1, 3.0, n_terms)
        qgroup[q, :n_terms] = np.sort(rng.integers(0, g, n_terms))
        if q % 2:
            need[q] = len(set(qgroup[q, :n_terms].tolist()))
    gmat = np.zeros((b, m, g), np.float32)
    for q in range(b):
        for j in range(m):
            if qgroup[q, j] >= 0:
                gmat[q, j, qgroup[q, j]] = 1.0
    return term_ids, sat, qterms, idf, qgroup, need, gmat


def _tensors(term_ids, sat, qterms, idf, qgroup, need):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        term_ids, sat, impact_bm25.pack_query_terms(qterms, idf, qgroup),
        need)]


def _numpy_topk(term_ids, sat, qterms, idf, qgroup, need, k):
    """The formula doc by doc in numpy f32 (one rounding per product and
    per sum, terms in order), then lax.top_k's order by a lexsort."""
    b = qterms.shape[0]
    vals = np.zeros((b, k), np.float32)
    ids = np.zeros((b, k), np.int64)
    for q in range(b):
        score = np.zeros(N_PAD, np.float32)
        hit = np.zeros((N_PAD, qterms.shape[1]), bool)
        for j in range(qterms.shape[1]):
            if qterms[q, j] < 0:
                break
            eq = term_ids == qterms[q, j]
            st = np.where(eq, sat, np.float32(0)).sum(1, dtype=np.float32)
            score = (score + st * idf[q, j]).astype(np.float32)
            hit[:, j] = eq.any(1)
        groups = np.zeros(N_PAD, np.int32)
        for grp in set(qgroup[q][qgroup[q] >= 0].tolist()):
            groups += hit[:, qgroup[q] == grp].any(1)
        score = np.where(groups >= need[q], score, np.float32(-np.inf))
        order = np.lexsort((np.arange(N_PAD), -score))[:k]
        vals[q], ids[q] = score[order], order
    return vals, ids


CASES = {                     # (n_docs, tie)
    "full": (N_PAD, False),
    "pad-tail": (N_PAD - 45, False),
    "all-tie": (N_PAD - 12, True),
}


@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_topk_matches_the_jax_program(case, k):
    n_docs, tie = CASES[case]
    term_ids, sat, qterms, idf, qgroup, need, gmat = _operands(
        len(case) + k, n_docs, tie=tie)
    b, m, g = gmat.shape
    run = jdev._impact_topk_program(N_PAD, term_ids.shape[1], m, b, g, k, TILE)
    wv, wi = (np.asarray(a) for a in run(
        *map(jnp.asarray, (term_ids, sat, qterms, idf, gmat, need))))
    ops = _tensors(term_ids, sat, qterms, idf, qgroup, need)
    gv, gi = impact_bm25._impact_bm25_topk_plain(*ops, k)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int64
    np.testing.assert_array_equal(gi.numpy(), wi.astype(np.int64))
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv.numpy()), fin)
    np.testing.assert_allclose(gv.numpy()[fin], wv[fin], rtol=1e-6, atol=0)
    nv, ni = _numpy_topk(term_ids, sat, qterms, idf, qgroup, need, k)
    np.testing.assert_array_equal(gi.numpy(), ni)
    assert gv.numpy().tobytes() == nv.tobytes()
    assert np.isinf(gv.numpy()[0]).all()             # the all-pad query
    if k > 3:                                        # fewer than k
        assert np.isfinite(gv.numpy()[1]).sum() == (0 if tie else 3)
    # the wrapper on CPU tensors is the plain version
    tv, ti = impact_bm25.impact_bm25_topk(*ops, k)
    assert torch.equal(ti, gi) and torch.equal(tv, gv)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["desc", "asc"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_plain_fused_topk_matches_the_jax_program(metric, sign):
    term_ids, sat, qterms, idf, qgroup, need, gmat = _operands(
        11, N_PAD - 30)
    b, m, g = gmat.shape
    rng = np.random.default_rng(4)
    d = 16
    emb = rng.standard_normal((N_PAD, d)).astype(np.float32)
    emb[N_PAD - 30:] = 0.0
    if metric == "cosine":
        emb[:N_PAD - 30] /= np.linalg.norm(emb[:N_PAD - 30], axis=1,
                                           keepdims=True)
    Q = rng.standard_normal((b, d)).astype(np.float32)
    w_s, w_d = np.float32(sign * 0.04), np.float32(sign * -1.0)
    k = 10
    run = jdev._impact_fused_topk_program(N_PAD, term_ids.shape[1], m, b, g,
                                          k, TILE, d, metric)
    wv, wi = (np.asarray(a) for a in run(
        *map(jnp.asarray, (term_ids, sat, qterms, idf, gmat, need, emb, Q)),
        w_s, w_d))
    ops = _tensors(term_ids, sat, qterms, idf, qgroup, need)
    dist = tdev._vector_distance(torch.from_numpy(emb), torch.from_numpy(Q),
                                 metric)
    gv, gi = impact_bm25._impact_bm25_topk_plain(
        *ops, k, dist, float(w_s), float(w_d))
    np.testing.assert_array_equal(gi.numpy(), wi.astype(np.int64))
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv.numpy()), fin)
    np.testing.assert_allclose(gv.numpy()[fin], wv[fin], rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------- the kernel's selection
INT64_MIN = -(1 << 63)


def _keys(values: torch.Tensor) -> torch.Tensor:
    """The kernel's u64 key, (ord(score) << 32) | (0xffffffff - doc), less
    2^63 so that it is an int64 of the same order; the kernel's empty key 0
    is INT64_MIN here."""
    bits = values.view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    doc = torch.arange(values.shape[1], dtype=torch.int64)
    return ordered * (1 << 32) + (0xFFFFFFFF - doc)


def _cut(buf, k):
    """The kernel's cut: the buffer sorted descending, its first k kept."""
    return sorted(buf, reverse=True)[:k]


def _buffer_keys(k):
    """Keys of a warp's buffer for one query: 32 * R, at least k + 32."""
    return 32 * (2 if k <= 32 else 4 if k <= 96 else 8)


class _Warp:
    """One warp's selection for one query: a buffer and a threshold, fed 32
    keys (one a lane) at a time; a ballot that would overflow the buffer
    cuts it first, and the threshold rises to the k-th key."""

    def __init__(self, k):
        self.k, self.cap = k, _buffer_keys(k)
        self.buf, self.thr = [], INT64_MIN

    def offer(self, lanes):
        passing = [x for x in lanes if x > self.thr]
        if not passing:
            return
        if len(self.buf) + len(passing) > self.cap:
            self.buf = _cut(self.buf, self.k)
            self.thr = self.buf[-1]
            passing = [x for x in lanes if x > self.thr]
        self.buf += passing            # lanes in order: ballot + popc
        assert len(self.buf) <= self.cap

    def top(self):
        self.buf = _cut(self.buf, self.k)
        return self.buf


class _Slot:
    """One slot of a selecting block (a quarter-warp: a query and a way): a
    buffer and a threshold, fed one item's keys (32 docs) at a time. Before
    each item it takes the query's threshold shared by all blocks
    (``shared``, one value); a buffer that could not take another item's 32
    keys is cut, its threshold rises to the k-th key and the shared one to
    at least that."""

    def __init__(self, k, shared):
        self.k, self.cap, self.shared = k, _buffer_keys(k), shared
        self.buf, self.thr = [], INT64_MIN

    def step(self, keys):
        self.thr = max(self.thr, self.shared[0])
        self.buf += [x for x in keys if x > self.thr]
        assert len(self.buf) <= self.cap
        if len(self.buf) > self.cap - 32:
            self.buf = _cut(self.buf, self.k)
            self.thr = max(self.thr, self.buf[-1])
            self.shared[0] = max(self.shared[0], self.thr)


def _select_like_the_kernel(keys, k, subs, ways, blocks, warps=8):
    """Phase one: block x of ``blocks`` walks the strips x, x + blocks, ..
    of ``32 * subs`` docs, the blocks in turns strip by strip (one order in
    which the card may run them); each of a query's ``ways`` slots takes
    the sub-strips way, way + ways, .. of a strip, 32 docs an item (pad
    docs past the row give the empty key); at the end each slot is cut, the
    first slot takes the others' keys as a warp does, and the block's top k
    (padded with the empty key) goes to ``part``. Phase two: ``warps``
    warps scan the query's part in the kernel's interleaving, warp 0 merges
    the others' top k."""
    n = keys.shape[1]
    sdocs = 32 * subs
    strips = -(-n // sdocs)
    out = []
    for row in keys.tolist():
        row = row + [INT64_MIN] * (strips * sdocs - n)
        shared = [INT64_MIN]
        slots = [[_Slot(k, shared) for _ in range(ways)]
                 for _ in range(blocks)]
        for first in range(0, strips, blocks):
            for x in range(blocks):
                s = first + x
                for w, slot in enumerate(slots[x] if s < strips else []):
                    for sub in range(w, subs, ways):
                        d0 = s * sdocs + sub * 32
                        slot.step(row[d0:d0 + 32])
        part = []
        for block in slots:
            lead = _Warp(k)
            lead.buf = _cut(block[0].buf, k)
            lead.thr = lead.buf[-1] if len(lead.buf) == k else INT64_MIN
            for slot in block[1:]:
                top = _cut(slot.buf, k)
                for j in range(0, len(top), 32):
                    lead.offer(top[j:j + 32])
            top = lead.top()
            part += top + [INT64_MIN] * (k - len(top))
        ws = [_Warp(k) for _ in range(warps)]
        for wi, w in enumerate(ws):
            for base in range(wi * 32, len(part), warps * 32):
                w.offer(part[base:base + 32])
        lead = ws[0]
        lead.top()
        lead.thr = lead.buf[-1] if len(lead.buf) == k else INT64_MIN
        for w in ws[1:]:
            top = w.top()
            for j in range(0, len(top), 32):
                lead.offer(top[j:j + 32])
        out.append(lead.top())
    return torch.tensor(out, dtype=torch.int64)


def _unkey(keys):
    hi = keys >> 32
    bits = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).to(torch.int32)
    return bits.view(torch.float32), 0xFFFFFFFF - (keys & 0xFFFFFFFF)


@pytest.mark.parametrize("k,subs,ways,blocks", [
    (1, 8, 1, 3), (10, 8, 1, 5), (10, 16, 8, 7), (10, 2, 2, 40),
    (40, 64, 64, 2), (128, 1, 1, 4), (128, 16, 8, 1)])
def test_strip_then_merge_selection_is_the_tie_rule_top_k(k, subs, ways,
                                                          blocks):
    """The kernel's algorithm in torch: u64 keys (as ordered int64), a
    buffer per slot over the block's strips in any order of its ways, a
    threshold shared by the blocks, a merge of a query's slots in the block
    and of the blocks' top k (blocks past the last strip give empty keys
    only). It equals
    ``topk_largest_lowest_index`` on the same scores: signed zeros, -inf
    runs, ties by the hundred, scores rising with the doc (each doc enters
    the top k: the most cuts)."""
    rng = np.random.default_rng(k + subs + ways + blocks)
    n = 1500
    pool = np.array([0.0, -0.0, 1.5, 2.5, -3.0, -np.inf], np.float32)
    scores = pool[rng.integers(0, len(pool), (4, n))]
    scores[1] = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    scores[1, ::9] = 0.25
    scores[2, 200:1400] = -np.inf
    scores[3] = rng.standard_normal(n).astype(np.float32)
    values = torch.from_numpy(scores)
    got = _select_like_the_kernel(_keys(values), k, subs, ways, blocks)
    gv, gi = _unkey(got)
    wv, wi = topk_largest_lowest_index(values, k)
    assert torch.equal(gi, wi)
    assert gv.numpy().tobytes() == wv.numpy().tobytes()


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("n_pad", [12, 262_144])
@pytest.mark.parametrize("b", [1, 8, 128, 130])
@pytest.mark.parametrize("m", [4, 16, 700])
@pytest.mark.parametrize("k", [1, 40, 128])
def test_topk_plan_fits_the_kernel(n_pad, b, m, k):
    """What the C launcher accepts (``topk_plan_ok``): the scores kernel's
    units (the host packed the vocabulary by them), a slot a quarter-warp
    at most, ways that divide the strip (one item a slot across chunks),
    the table and the buffers within the shared memory budget, blocks no
    more than the strips. It fills the card: as many ways as the block's
    quarter-warps take, blocks enough for the card's SMs where the strips
    allow, the fewest blocks a unit's queries."""
    k = min(k, n_pad)
    p = impact_bm25._topk_plan(n_pad, b, m, k)
    assert (p.queries, p.terms) == impact_bm25.query_units(b, m)
    assert p.units == -(-b // p.queries) and p.chunks == -(-m // p.terms)
    assert p.r == (2 if k <= 32 else 4 if k <= 96 else 8)
    assert 32 * p.r >= k + 32
    assert p.qsplit == -(-p.queries // p.group)
    slots = p.group * p.ways
    assert slots <= impact_bm25.TOPK_SLOTS
    for x in (p.subs, p.ways):
        assert x >= 1 and x & (x - 1) == 0
    assert p.ways <= p.subs <= impact_bm25.TOPK_MAX_SUBS
    assert p.subs == 1 or 32 * p.subs < 2 * n_pad
    assert impact_bm25._topk_smem(p.queries, p.terms, p.subs, slots, p.r) \
        <= impact_bm25.TOPK_SMEM
    if p.chunks > 1:
        assert p.ways == p.subs
    else:
        assert p.ways == p.subs or 2 * slots > impact_bm25.TOPK_SLOTS
    strips = -(-n_pad // (32 * p.subs))
    assert p.blocks == max(1, min(strips, impact_bm25.SMS
                                  // (p.units * p.qsplit)))
    fewest = -(-p.queries // impact_bm25.TOPK_SLOTS)
    assert p.qsplit >= fewest
    if p.qsplit > fewest:     # one block fewer a unit would not fit
        group = -(-p.queries // (p.qsplit - 1))
        assert impact_bm25._topk_smem(p.queries, p.terms, 1, group, p.r) \
            > impact_bm25.TOPK_SMEM


# (b, m, k) -> (units, group, qsplit, subs, ways, blocks) on a block of
# 262,144 docs: the shapes of chip_smoke.py's kernel phase (L = 8, 64, 512
# take the same plan: the table holds a sub-strip's cells, not its rows)
@pytest.mark.parametrize("slots", [8, 64, 512])
@pytest.mark.parametrize("b,m,k,want", [
    (128, 4, 10, (1, 64, 2, 2, 1, 66)),
    (8, 4, 10, (1, 8, 1, 32, 8, 132)),
    (1, 4, 10, (1, 1, 1, 64, 64, 128)),
    (128, 8, 10, (2, 64, 1, 2, 1, 66)),
    (128, 4, 128, (1, 64, 2, 1, 1, 66)),
    (16, 128, 10, (2, 8, 1, 2, 2, 66))])
def test_topk_plan_at_the_path_shapes(slots, b, m, k, want):
    """Two blocks of 64 queries a unit at b = 128 (a slot a quarter-warp),
    one block an SM; 8 ways a query at b = 8 and 64 at b = 1, so that
    every quarter-warp of a block selects; a query of several chunks in a
    slot a sub-strip."""
    p = impact_bm25._topk_plan(262_144, b, m, k)
    assert (p.units, p.group, p.qsplit, p.subs, p.ways, p.blocks) == want
    # the wrapper's scratch: the blocks' top k and a threshold per query
    assert b * (p.blocks * k + 1) * 8 < 16 << 20
    rng = np.random.default_rng(slots)
    qpack = impact_bm25.pack_query_terms(*_query_batch(rng, b, m, 3 * slots))
    assert qpack[..., 3].max() < p.queries * p.terms


def _query_batch(rng, b, m, vocab):
    """Queries of 1 to m distinct terms of ``vocab``, groups of one."""
    qterms = np.full((b, m), -1, np.int32)
    idf = np.zeros((b, m), np.float32)
    qgroup = np.full((b, m), -1, np.int32)
    for q in range(b):
        n = int(rng.integers(1, min(m, vocab) + 1))
        qterms[q, :n] = rng.choice(vocab, n, replace=False)
        idf[q, :n] = rng.uniform(0.1, 3.0, n)
        qgroup[q, :n] = np.arange(n)
    return qterms, idf, qgroup


# ------------------------------------------------------------ the wrapper
def _small():
    term_ids, sat, qterms, idf, qgroup, need, _ = _operands(1, N_PAD - 7)
    return _tensors(term_ids, sat, qterms, idf, qgroup, need)


def test_topk_wrapper_rejects_what_the_kernel_does_not_take():
    ops = _small()
    with pytest.raises(TypeError):
        impact_bm25.impact_bm25_topk(ops[0].long(), *ops[1:], 5)
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_topk(ops[0], ops[1][:, :4], *ops[2:], 5)
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_topk(ops[0], ops[1], ops[2][..., :3], ops[3],
                                     5)
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_topk(*ops, 5, dist=torch.zeros(6, N_PAD - 1))
    for k in (0, N_PAD + 1):
        with pytest.raises(ValueError):
            impact_bm25.impact_bm25_topk(*ops, k)
    assert impact_bm25.impact_bm25_topk.launches == 0     # CPU: plain


def test_topk_wrapper_sends_large_k_to_the_scores_and_top_k(monkeypatch):
    """Above MAX_K the scores kernel's wrapper runs (and counts its own
    launch on the card), then the tie-rule top-k; at MAX_K it does not."""
    ops = _small()
    calls = []
    real = impact_bm25.impact_bm25_scores
    monkeypatch.setattr(impact_bm25, "impact_bm25_scores",
                        lambda *a: calls.append(len(a)) or real(*a))
    for k in (impact_bm25.MAX_K, impact_bm25.MAX_K + 1, N_PAD):
        before = len(calls)
        gv, gi = impact_bm25.impact_bm25_topk(*ops, k)
        assert len(calls) - before == (k > impact_bm25.MAX_K)
        wv, wi = impact_bm25._impact_bm25_topk_plain(*ops, k)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("k", [10, impact_bm25.MAX_K + 5])
def test_impact_dispatch_goes_through_the_selecting_wrapper(k, monkeypatch):
    """Both dispatch sites call ``impact_bm25_topk`` once a batch, and the
    served rows and scores are those of the plain scores and the tie-rule
    top-k, at a k on either side of MAX_K (the reference's top_k_batch is
    held by tests/test_torch_bm25_device.py)."""
    term_ids, sat, qterms, idf, qgroup, need, _ = _operands(2, N_PAD - 3)

    class _Reader:        # what ImpactBM25 reads of a block's postings
        n_docs = N_PAD - 3

    calls = []
    real = impact_bm25.impact_bm25_topk
    monkeypatch.setattr(tdev, "impact_bm25_topk",
                        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw))
    scorer = tdev.ImpactBM25.__new__(tdev.ImpactBM25)
    scorer.reader, scorer.n_docs = _Reader, _Reader.n_docs
    scorer.n_pad, scorer.L = N_PAD, term_ids.shape[1]
    scorer._term_ids = torch.from_numpy(term_ids)
    scorer._sat = torch.from_numpy(sat)
    scorer._df = np.arange(1, 2 * scorer.L + 1, dtype=np.int64) * 7
    queries = [[[1], [2, 3]], [[4]], [[-1]], []]
    got = scorer.top_k_batch(queries, k, "OR")
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N_PAD, 8)).astype(np.float32))
    Q = np.ones((len(queries), 8), np.float32)
    scorer.fused_top_k_batch(queries, k, "AND", emb, Q, 0.04, -1.0, "ip")
    assert calls == [k, k]
    # the same batch through the plain scores and the tie-rule top-k
    qt, idf_, qg, nd, drop, _, _, _ = scorer._pack_queries(queries, "OR")
    dense = impact_bm25._impact_bm25_scores_plain(
        scorer._term_ids, scorer._sat,
        torch.from_numpy(impact_bm25.pack_query_terms(qt, idf_, qg)),
        torch.from_numpy(nd))
    wv, wi = topk_largest_lowest_index(dense, k)
    for q, (rows, vals) in enumerate(got):
        ok = np.isfinite(wv[q].numpy())
        np.testing.assert_array_equal(rows, wi[q].numpy()[ok])
        assert vals.tobytes() == wv[q].numpy()[ok].tobytes()
