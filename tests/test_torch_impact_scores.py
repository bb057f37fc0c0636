"""The dense BM25 scores of the port (``ops.impact_bm25.impact_bm25_scores``)
and the batch vocabulary its CUDA kernel reads, on the CPU.

The kernel looks each doc slot up once in the sorted vocabulary of the query
batch; the host writes each query term's row in that vocabulary into the
fourth word of ``qpack`` (``pack_query_terms``) and checks it
(``check_vocabulary``). Here:

* the rows against numpy (the index of each real term in the sorted distinct
  terms of its unit, -1 on pads), through ``pack_query_terms`` and through
  ``ImpactBM25._pack_queries``; the units and chunks of ``query_units`` and
  the launch plan;
* ``check_vocabulary`` rejecting rows that are unsorted, out of range or
  inconsistent with the terms, and the wrapper rejecting a wrong shape,
  dtype or device (a tensor that is not on the CPU never takes the plain
  version);
* the kernel's algorithm written out in numpy (a table of saturations per
  (vocabulary row, doc), built once per unit and chunk, then one lookup per
  (query, term)), bit-equal to the plain version;
* ``ImpactBM25.top_k_batch`` and the fused batch at ``k = MAX_K + 1`` and
  ``k = n_pad`` (the route through ``impact_bm25_scores`` and the tie-rule
  top-k), held to the JAX package's ``ImpactBM25`` on the same seeded corpus
  (ids equal, scores rtol 1e-6), on a corpus of distinct scores and on one
  where every score ties.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.expression import Column
from databend_tpu.index.inverted import device as jdev
from databend_tpu.index.inverted.reader import InvertedBlockReader as JaxReader
from databend_tpu.index.inverted.writer import build_inverted_index
from databend_tpu.types import String
from databend_tpu.utils import tracing as jtracing

from databend_tpu_torch import backend
from databend_tpu_torch.index.inverted import device as tdev
from databend_tpu_torch.index.inverted.reader import \
    InvertedBlockReader as TorchReader
from databend_tpu_torch.ops import impact_bm25
from databend_tpu_torch.utils import tracing as ttracing

WORDS = ["red", "fox", "jumps", "over", "lazy", "dog", "whale", "blue",
         "crab", "runs", "fast", "slow", "green", "hill", "sea"]
TIE_WORDS = ["weather", "news", "google", "maps"]


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    """Empty both packages' process-wide span rings after the module, so
    that a later test file on this worker reads only its own spans."""
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _query_batch(rng, b, m, vocab, real=None):
    """``[b, m]`` terms (some shared across queries and repeated within
    one), idf and groups; query ``q`` has ``real[q]`` real terms, then
    pads."""
    if real is None:
        real = rng.integers(1, m + 1, b)
    qterms = np.full((b, m), -1, np.int32)
    idf = np.zeros((b, m), np.float32)
    qgroup = np.full((b, m), -1, np.int32)
    for q in range(b):
        n = int(real[q])
        qterms[q, :n] = rng.integers(0, vocab, n)
        idf[q, :n] = rng.uniform(0.1, 3.0, n)
        qgroup[q, :n] = np.sort(rng.integers(0, max(1, n // 2 + 1), n))
    return qterms, idf, qgroup


def _unit_rows(qterms):
    """The vocabulary rows by their definition, entry by entry."""
    b, m = qterms.shape
    gq, mc = impact_bm25.query_units(b, m)
    want = np.full((b, m), -1, np.int32)
    for q0 in range(0, b, gq):
        for j0 in range(0, m, mc):
            block = qterms[q0:q0 + gq, j0:j0 + mc]
            vocab = np.unique(block[block >= 0])
            want[q0:q0 + gq, j0:j0 + mc] = np.where(
                block >= 0, np.searchsorted(vocab, block), -1)
    return want


@pytest.mark.parametrize("b,m", [(1, 4), (6, 4), (128, 4)])
def test_vocabulary_rows_index_the_sorted_batch_terms(b, m):
    """One unit: the row of a real term is its index in the sorted distinct
    real terms of the whole batch; a term shared by queries has one row."""
    rng = np.random.default_rng(b)
    qterms, idf, qgroup = _query_batch(rng, b, m, 40)
    assert impact_bm25.query_units(b, m) == (b, m)
    qpack = impact_bm25.pack_query_terms(qterms, idf, qgroup)
    rows = qpack[..., 3]
    vocab = np.unique(qterms[qterms >= 0])
    np.testing.assert_array_equal(
        rows, np.where(qterms >= 0, np.searchsorted(vocab, qterms), -1))
    np.testing.assert_array_equal(qpack[..., 0], qterms)
    np.testing.assert_array_equal(qpack[..., 1].view(np.float32), idf)
    np.testing.assert_array_equal(qpack[..., 2], qgroup)
    for t in vocab:                # one row a term, across the batch
        assert len(np.unique(rows[qterms == t])) == 1
    torch_pack = impact_bm25.pack_query_terms(
        *(torch.from_numpy(a) for a in (qterms, idf, qgroup)))
    assert torch.equal(torch_pack, torch.from_numpy(qpack))


@pytest.mark.parametrize("b,m,units,chunks", [
    (128, 8, 2, 1), (128, 16, 4, 1), (16, 128, 2, 2), (3, 700, 1, 5),
    (12, 100, 2, 2)])
def test_vocabulary_rows_by_unit_and_chunk(b, m, units, chunks):
    """Past UNIT_ENTRIES entries a unit holds fewer queries (and past eight
    queries' worth of terms, a chunk fewer terms): rows index each unit and
    chunk's own sorted terms."""
    rng = np.random.default_rng(m)
    qterms, idf, qgroup = _query_batch(rng, b, m, 5 * m)
    plan = impact_bm25._scores_plan(4096, b, m)
    assert (plan.units, plan.chunks) == (units, chunks)
    qpack = impact_bm25.pack_query_terms(qterms, idf, qgroup)
    np.testing.assert_array_equal(qpack[..., 3], _unit_rows(qterms))
    assert qpack[..., 3].max() < plan.queries * plan.terms


@pytest.mark.parametrize("n_pad", [96, 2048, 262_144])
@pytest.mark.parametrize("b", [1, 5, 8, 64, 128, 1024])
@pytest.mark.parametrize("m", [4, 8, 16, 64, 100, 128, 1024])
def test_scores_plan_fits_the_kernel(n_pad, b, m):
    """What the C launcher accepts (``scores_plan_ok``): a unit fits the
    table and the table the shared memory, a quad of items carried across
    chunks has a warp of its own, the units and chunks cover the batch, and
    a unit's quads split over blocks only while the strips do not fill the
    card."""
    p = impact_bm25._scores_plan(n_pad, b, m)
    assert 1 <= p.queries <= b and 1 <= p.terms <= m
    assert p.queries * p.terms <= impact_bm25.UNIT_ENTRIES
    assert p.units == -(-b // p.queries) and p.chunks == -(-m // p.terms)
    assert 1 <= p.subs <= impact_bm25.MAX_SUBS
    assert impact_bm25._scores_smem(p.queries, p.terms, p.subs) \
        <= impact_bm25.SCORES_SMEM
    quads = -(-p.queries * p.subs // 4)              # four items a warp
    if p.chunks > 1:
        assert p.queries <= impact_bm25.CHUNKED_QUERIES and p.qsplit == 1
        assert quads <= impact_bm25.SCORES_WARPS     # a quad a warp
    else:
        assert p.terms == m
    assert 1 <= p.qsplit <= -(-quads // impact_bm25.SCORES_WARPS)
    strips = -(-n_pad // (32 * p.subs))
    if p.qsplit > 1:
        assert strips * p.units * (p.qsplit - 1) < impact_bm25.FILL_BLOCKS


@pytest.mark.parametrize("b,m,subs", [(128, 4, 1), (128, 8, 1), (8, 4, 8),
                                      (1, 4, 8), (16, 128, 1)])
def test_scores_plan_at_the_path_shapes(b, m, subs):
    """One 32-doc sub-strip a strip where the unit's table is largest, up
    to eight where the batch is small (a block of 262,144 docs)."""
    assert impact_bm25._scores_plan(262_144, b, m).subs == subs


@pytest.mark.parametrize("b,m,rows,subs", [
    (128, 4, 17, 8), (128, 4, 60, 8), (128, 4, 200, 2), (128, 4, 512, 1),
    (8, 4, 16, 8), (16, 128, 64, 1)])
def test_strips_widen_to_the_vocabulary(b, m, rows, subs):
    """With one chunk the kernel widens the plan's strips while the unit's
    vocabulary rows (and the row of NaN) fit the table the plan sized."""
    plan = impact_bm25._scores_plan(262_144, b, m)
    assert impact_bm25.strip_subs(plan, rows) == subs
    words = (plan.queries * plan.terms + 1) * (32 * plan.subs + 4)
    assert (rows + 1) * (32 * subs + 4) <= words


def test_pack_queries_vocabulary(corpus):
    """``ImpactBM25._pack_queries`` then ``pack_query_terms``, as both
    dispatch sites run them: a fuzzy group's terms, a word shared by
    queries and unknown terms (-1) all get their rows."""
    _, tr = corpus
    scorer = tdev.ImpactBM25.try_create(tr)
    queries = [_groups(tr, s) for s in SPECS]
    qterms, idf, qgroup, _, _, b, m, _ = scorer._pack_queries(queries, "OR")
    qpack = impact_bm25.pack_query_terms(qterms, idf, qgroup)
    assert impact_bm25.query_units(b, m) == (b, m)
    vocab = np.unique(qterms[qterms >= 0])
    np.testing.assert_array_equal(
        qpack[..., 3], np.where(qterms >= 0, np.searchsorted(vocab, qterms),
                                -1))
    red = tr.term_id("red")
    assert len(np.unique(qpack[..., 3][qterms == red])) == 1
    assert (qterms == red).sum() > 1


def _corrupt(kind):
    rng = np.random.default_rng(3)
    qterms, idf, qgroup = _query_batch(rng, 4, 4, 30, real=[4, 3, 2, 1])
    qterms[1, 0] = qterms[0, 0]              # a term of two queries
    qpack = impact_bm25.pack_query_terms(qterms, idf, qgroup)
    rows = qpack[..., 3]
    order = np.argsort(np.unique(qterms[qterms >= 0]))
    if kind == "unsorted":                   # two rows trade their terms
        lo, hi = rows == order[0], rows == order[-1]
        rows[lo], rows[hi] = order[-1], order[0]
    elif kind == "out of range":
        rows[rows == rows.max()] = rows.max() + 1
    elif kind == "negative":
        rows[0, 0] = -1
    elif kind == "inconsistent":             # one term, two rows
        rows[1, 0] = (rows[0, 0] + 1) % (rows.max() + 1)
    elif kind == "pad":
        rows[3, 3] = 0
    return qpack


@pytest.mark.parametrize("kind,message", [
    ("unsorted", "not sorted"), ("out of range", "out of range"),
    ("negative", "out of range"), ("inconsistent", "inconsistent"),
    ("pad", "pad term")])
def test_check_vocabulary_rejects(kind, message):
    qpack = _corrupt(kind)
    with pytest.raises(ValueError, match=message):
        impact_bm25.check_vocabulary(qpack)


def test_check_vocabulary_accepts_what_pack_builds():
    for b, m in ((4, 4), (128, 16), (16, 128)):
        rng = np.random.default_rng(b * m)
        qpack = impact_bm25.pack_query_terms(*_query_batch(rng, b, m, 300))
        impact_bm25.check_vocabulary(qpack)


def _operands(rng, n_docs, n_pad, slots, b, m, vocab):
    term_ids = np.full((n_pad, slots), -2, np.int32)
    sat = np.zeros((n_pad, slots), np.float32)
    for d in range(n_docs):
        cnt = int(rng.integers(1, slots + 1))
        term_ids[d, :cnt] = rng.choice(vocab, cnt, replace=False)
        sat[d, :cnt] = rng.uniform(0.5, 2.0, cnt)
    qterms, idf, qgroup = _query_batch(rng, b, m, vocab)
    need = np.ones(b, np.float32)
    for q in range(1, b, 2):
        need[q] = len(set(qgroup[q][qgroup[q] >= 0].tolist()))
    return term_ids, sat, impact_bm25.pack_query_terms(qterms, idf, qgroup), \
        need


def _kernel_in_numpy(term_ids, sat, qpack, need, dist, w_s, w_d):
    """csrc/impact_bm25_scores.cu's algorithm: per unit and chunk a table of
    saturations by (vocabulary row, doc), NaN where the doc lacks the term,
    built from the rows the host packed; then per (query, term) one lookup,
    the product in f32 and the sum in f64 (rounded to f32 once, after the
    last term), and the group runs."""
    n_pad = term_ids.shape[0]
    b, m = qpack.shape[:2]
    gq, mc = impact_bm25.query_units(b, m)
    f32 = np.float32
    score = np.zeros((b, n_pad), np.float64)
    groups = np.zeros((b, n_pad), np.int32)
    run_hit = np.zeros((b, n_pad), bool)
    done = np.zeros(b, bool)                  # a pad term was reached
    for q0 in range(0, b, gq):
        for j0 in range(0, m, mc):
            entries = qpack[q0:q0 + gq, j0:j0 + mc]
            real = entries[..., 0] >= 0
            nv = int(entries[..., 3][real].max(initial=-1)) + 1
            voc = np.zeros(nv, np.int32)
            voc[entries[..., 3][real]] = entries[..., 0][real]
            table = np.full((nv, n_pad), np.nan, f32)
            d, s = np.nonzero(np.isin(term_ids, voc))
            table[np.searchsorted(voc, term_ids[d, s]), d] = sat[d, s]
            for q in range(q0, min(b, q0 + gq)):
                for j in range(j0, min(m, j0 + mc)):
                    term, idf_bits, group, row = qpack[q, j]
                    done[q] |= term < 0
                    if done[q]:
                        break
                    x = table[row]
                    hit = ~np.isnan(x)
                    idf = np.array(idf_bits, np.int32).view(f32)
                    score[q] = score[q] + (idf * np.where(hit, x, f32(0))
                                           ).astype(np.float64)
                    if j == 0 or qpack[q, j - 1, 2] != group:
                        groups[q] += run_hit[q]
                        run_hit[q] = False
                    run_hit[q] |= hit
    groups += run_hit
    score = score.astype(f32)
    if dist is not None:
        score = f32(w_s) * score + f32(w_d) * dist
    return np.where(groups.astype(f32) >= need[:, None], score, f32(-np.inf))


@pytest.mark.parametrize("fused", [False, True], ids=["text", "fused"])
@pytest.mark.parametrize("slots,b,m,vocab", [
    (8, 6, 4, 17), (8, 128, 4, 40), (16, 128, 8, 60), (8, 40, 16, 60),
    (64, 16, 128, 600), (24, 3, 700, 2000)])
def test_vocabulary_table_gives_the_plain_bits(slots, b, m, vocab, fused):
    """The lookup table the kernel builds from the packed vocabulary rows
    scores bit for bit as the plain version, for one unit, several units
    and queries carried across chunks."""
    rng = np.random.default_rng(slots * b + m)
    n_docs, n_pad = 90, 96
    ops = _operands(rng, n_docs, n_pad, slots, b, m, vocab)
    dist = rng.standard_normal((b, n_pad)).astype(np.float32) if fused \
        else None
    w_s, w_d = (-0.04, 1.0) if fused else (1.0, 0.0)
    want = impact_bm25.impact_bm25_scores(
        *(torch.from_numpy(a) for a in ops),
        dist=torch.from_numpy(dist) if fused else None, w_s=w_s, w_d=w_d)
    got = _kernel_in_numpy(*ops, dist, w_s, w_d)
    assert np.isfinite(got).any() and not np.isfinite(got).all()
    assert got.tobytes() == want.numpy().tobytes()


def test_scores_wrapper_rejects_shape_dtype_and_device():
    rng = np.random.default_rng(0)
    ops = [torch.from_numpy(a) for a in _operands(rng, 10, 16, 8, 2, 4, 9)]
    with pytest.raises(ValueError):             # qpack [b, m, 3]
        impact_bm25.impact_bm25_scores(ops[0], ops[1], ops[2][..., :3],
                                       ops[3])
    with pytest.raises(ValueError):             # need [b + 1]
        impact_bm25.impact_bm25_scores(*ops[:3], torch.ones(3))
    with pytest.raises(TypeError):              # int64 qpack
        impact_bm25.impact_bm25_scores(ops[0], ops[1], ops[2].long(), ops[3])
    with pytest.raises(TypeError):              # f64 sat
        impact_bm25.impact_bm25_scores(ops[0], ops[1].double(), *ops[2:])
    meta = [t.to("meta") for t in ops]
    with pytest.raises(ValueError, match="different devices"):
        impact_bm25.impact_bm25_scores(*ops[:3], meta[3])
    with pytest.raises(ValueError, match="no kernel for meta"):
        impact_bm25.impact_bm25_scores(*meta)   # never the plain version
    assert impact_bm25.impact_bm25_scores.launches == 0


# ---------------------------------------------------- against the reference
SPECS = [["red"], ["red", "fox"], ["whale", "crab", "dog"], ["~red", "fox"],
         ["red", "?"], ["?"], [], ["blue", "red", "sea", "hill"]]


def _groups(reader, spec):
    out = []
    for w in spec:
        if w == "?":
            out.append([-1])
        elif w.startswith("~"):
            out.append(reader.fuzzy_term_ids(w[1:], 2))
        else:
            out.append([reader.term_id(w)])
    return out


def _index(docs):
    path = os.path.join(tempfile.mkdtemp(), "ii.npz")
    build_inverted_index(path, [Column.from_pylist(docs, String)],
                         {"tokenizer": "english", "filters": ""})
    return JaxReader.load(path), TorchReader.load(path)


@pytest.fixture(scope="module")
def corpus():
    """3,000 docs of 3-11 words from 15."""
    rng = np.random.default_rng(5)
    return _index([" ".join(WORDS[i] for i in rng.integers(
        0, len(WORDS), rng.integers(3, 12))) for _ in range(3000)])


@pytest.fixture(scope="module")
def tie_corpus():
    """3,000 docs of one text: every matched doc has one score."""
    return _index(["weather news"] * 3000)


def _same(got, want):
    assert len(got) == len(want)
    for (gr, gs), (wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("op", ["OR", "AND"])
@pytest.mark.parametrize("which", ["corpus", "tie_corpus"])
@pytest.mark.parametrize("k", ["max_k+1", "n_pad"])
def test_top_k_batch_above_max_k_matches_jax(which, k, op, request):
    jr, tr = request.getfixturevalue(which)
    ji, ti = jdev.ImpactBM25.try_create(jr), tdev.ImpactBM25.try_create(tr)
    k = impact_bm25.MAX_K + 1 if k == "max_k+1" else ti.n_pad
    specs = SPECS if which == "corpus" else [
        ["weather"], ["news", "?"], ["maps"], ["weather", "news"], []]
    before = impact_bm25.impact_bm25_scores.launches
    got = ti.top_k_batch([_groups(tr, s) for s in specs], k, op)
    want = ji.top_k_batch([_groups(jr, s) for s in specs], k, op)
    if op == "AND":
        # no groups: no row, as on the host (the reference's served program
        # ranks every doc with score 0)
        empty = specs.index([])
        assert len(got[empty][0]) == len(tr.bm25_scores([], op)[0]) == 0
        assert len(want[empty][0]) == min(k, ti.n_docs)
        got, want = got[:empty] + got[empty + 1:], \
            want[:empty] + want[empty + 1:]
    _same(got, want)
    assert impact_bm25.impact_bm25_scores.launches == before   # CPU: plain
    if which == "tie_corpus":       # the lowest rows of the one score class
        rows, scores = got[0]
        np.testing.assert_array_equal(rows, np.arange(min(k, 3000)))
        assert len(np.unique(scores)) == 1


@pytest.mark.parametrize("which", ["corpus", "tie_corpus"])
@pytest.mark.parametrize("k", ["max_k+1", "n_pad"])
def test_fused_batch_above_max_k_matches_jax(which, k, request):
    """``0.04 * score() - cosine_distance``: the distance term through the
    scores' ``dist`` operand, on unit rows (cosine), held to the reference's
    fused program."""
    jr, tr = request.getfixturevalue(which)
    ji, ti = jdev.ImpactBM25.try_create(jr), tdev.ImpactBM25.try_create(tr)
    k = impact_bm25.MAX_K + 1 if k == "max_k+1" else ti.n_pad
    rng = np.random.default_rng(11)
    d = 8
    emb = rng.standard_normal((ti.n_pad, d)).astype(np.float32)
    emb[ti.n_docs:] = 0.0
    emb[:ti.n_docs] /= np.linalg.norm(emb[:ti.n_docs], axis=1, keepdims=True)
    specs = SPECS[:4] if which == "corpus" else [["weather"], ["news", "?"]]
    Q = rng.standard_normal((len(specs), d)).astype(np.float32)
    want = ji.fused_top_k_batch([_groups(jr, s) for s in specs], k, "OR",
                                jnp.asarray(emb), Q, 0.04, -1.0, "cosine")
    got = ti.fused_top_k_batch([_groups(tr, s) for s in specs], k, "OR",
                               backend.to_device(emb), Q, 0.04, -1.0,
                               "cosine")
    _same(got, want)
