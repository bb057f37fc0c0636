"""Device BM25 of the port against the JAX package, on the CPU.

One seeded corpus is indexed once, by the JAX package's writer; both
packages load that file. The same term groups go through
``databend_tpu.index.inverted.device`` (jitted programs on the CPU backend)
and ``databend_tpu_torch.index.inverted.device`` (plain tensor programs;
``impact_bm25_scores`` runs its plain version on CPU tensors).

Tolerances: the CSR programs sum f32 contributions in different orders
(rtol 1e-4, the reference's own, tests/test_bm25_device.py); the impact
scorer adds at most a few products per doc (rtol 1e-5). Row ids are compared
wherever a score is not within that tolerance of a different neighbouring
score; exactly equal scores rank by ascending row id in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from databend_tpu.expression import Column
from databend_tpu.index.inverted import device as jdev
from databend_tpu.index.inverted.reader import InvertedBlockReader as JaxReader
from databend_tpu.index.inverted.writer import build_inverted_index
from databend_tpu.types import String

from databend_tpu_torch import backend
from databend_tpu_torch.index.inverted import device as tdev
from databend_tpu_torch.index.inverted.reader import \
    InvertedBlockReader as TorchReader
from databend_tpu_torch.ops import impact_bm25

WORDS = ["red", "fox", "jumps", "over", "lazy", "dog", "whale", "blue",
         "crab", "runs", "fast", "slow", "green", "hill", "sea"]
TIE_WORDS = ["weather", "news", "google", "maps", "cat", "videos", "python",
             "flights", "hotels", "music", "games", "sports", "stock",
             "market", "recipe", "travel"]
K = 10


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


def _index(path, docs):
    build_inverted_index(path, [Column.from_pylist(docs, String)],
                         {"tokenizer": "english", "filters": ""})
    return JaxReader.load(path), TorchReader.load(path)


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """3,000 docs of 3-11 words (the reference's device BM25 corpus)."""
    rng = np.random.default_rng(5)
    docs = [" ".join(WORDS[i] for i in rng.integers(0, len(WORDS),
                                                    rng.integers(3, 12)))
            for _ in range(3000)]
    return _index(str(tmp_path_factory.mktemp("ii") / "ii.npz"), docs)


@pytest.fixture(scope="module")
def tie_readers(tmp_path_factory):
    """3,000 docs of 2-4 words from 16: thousands of rows per score."""
    rng = np.random.default_rng(17)
    words = np.array(TIE_WORDS)[rng.integers(0, len(TIE_WORDS), (3000, 4))]
    nw = rng.integers(2, 5, 3000)
    docs = [" ".join(words[i, :nw[i]]) for i in range(3000)]
    return _index(str(tmp_path_factory.mktemp("tie") / "ii.npz"), docs)


def _groups(reader, spec):
    """spec: words; ``~word`` expands to the terms within edit distance 2,
    ``?`` is a group of one unknown term."""
    out = []
    for w in spec:
        if w == "?":
            out.append([-1])
        elif w.startswith("~"):
            out.append(reader.fuzzy_term_ids(w[1:], 2))
        else:
            out.append([reader.term_id(w)])
    return out


def _assert_same_topk(got, want, k, rtol):
    """(rows, scores) of both packages asked for k + 1: equal lengths,
    scores to rtol, and equal rows at every rank below k whose score is not
    within rtol of a DIFFERENT neighbouring score (rank k included)."""
    (gr, gs), (wr, ws) = got, want
    assert len(gr) == len(wr)
    np.testing.assert_allclose(gs, ws, rtol=rtol)
    for i in range(min(k, len(wr))):
        near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)
                and 0 < abs(float(ws[i]) - float(ws[j]))
                <= 2 * rtol * abs(float(ws[i]))]
        if not near:
            assert gr[i] == wr[i], (i, gr, wr)


QUERIES = [(["red"], "OR"), (["red", "fox"], "OR"), (["red", "fox"], "AND"),
           (["whale", "crab", "dog"], "AND"), (["~red", "fox"], "OR"),
           (["~red", "~dog"], "AND"), (["red", "?"], "OR"),
           (["red", "?"], "AND"), (["?"], "OR"), ([], "OR")]
QUERY_IDS = [f"{'+'.join(q) or 'empty'}-{op}" for q, op in QUERIES]


def test_fuzzy_group_has_several_terms(readers):
    _, tr = readers
    assert len(tr.fuzzy_term_ids("red", 2)) > 1


def test_port_reads_the_reference_index_file(readers):
    jr, tr = readers
    assert tr.terms == jr.terms and tr.n_docs == jr.n_docs == 3000
    for name in ("offsets", "doc_ids", "tfs", "doc_len"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))


def test_impact_state_matches_jax(readers):
    jr, tr = readers
    ji, ti = jdev.ImpactBM25.try_create(jr), tdev.ImpactBM25.try_create(tr)
    assert (ti.n_pad, ti.L, ti.n_docs) == (ji.n_pad, ji.L, ji.n_docs)
    assert ti._term_ids.dtype == torch.int32 and ti._sat.dtype == torch.float32
    np.testing.assert_array_equal(ti._term_ids.numpy(),
                                  np.asarray(ji._term_ids))
    assert ti._sat.numpy().tobytes() == np.asarray(ji._sat).tobytes()
    for tid in (0, len(tr.terms) - 1):
        assert ti._idf(tid) == ji._idf(tid)


def test_impact_declines_long_docs(readers, monkeypatch):
    _, tr = readers
    monkeypatch.setattr(tdev.ImpactBM25, "MAX_L", 4)
    assert tdev.ImpactBM25.try_create(tr) is None


@pytest.mark.parametrize("spec,op", QUERIES, ids=QUERY_IDS)
def test_device_score_matches_jax(readers, spec, op):
    jr, tr = readers
    want = jdev.DeviceBM25(jr).score(_groups(jr, spec), op)
    got = tdev.DeviceBM25(tr).score(_groups(tr, spec), op)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    host = tr.bm25_scores(_groups(tr, spec), op)
    np.testing.assert_array_equal(got[0], host[0])
    np.testing.assert_allclose(got[1], host[1], rtol=1e-4)


@pytest.mark.parametrize("spec,op", QUERIES, ids=QUERY_IDS)
def test_device_top_k_matches_jax(readers, spec, op):
    jr, tr = readers
    want = jdev.DeviceBM25(jr).top_k(_groups(jr, spec), K + 1, op)
    got = tdev.DeviceBM25(tr).top_k(_groups(tr, spec), K + 1, op)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    _assert_same_topk(got, want, K, 1e-4)


@pytest.mark.parametrize("op", ["OR", "AND"])
def test_device_top_k_batch_matches_jax(readers, op):
    jr, tr = readers
    specs = [q for q, _ in QUERIES]
    want = jdev.DeviceBM25(jr).top_k_batch(
        [_groups(jr, s) for s in specs], K + 1, op)
    got = tdev.DeviceBM25(tr).top_k_batch(
        [_groups(tr, s) for s in specs], K + 1, op)
    assert len(got) == len(specs)
    for g, w in zip(got, want):
        _assert_same_topk(g, w, K, 1e-4)


def test_device_top_k_batch_of_empty_queries(readers):
    _, tr = readers
    out = tdev.DeviceBM25(tr).top_k_batch([[], [[-1]]], K)
    assert [len(r) for r, _ in out] == [0, 0]


@pytest.mark.parametrize("op", ["OR", "AND"])
def test_impact_top_k_batch_matches_jax(readers, op):
    jr, tr = readers
    specs = [q for q, _ in QUERIES]
    want = jdev.ImpactBM25.try_create(jr).top_k_batch(
        [_groups(jr, s) for s in specs], K + 1, op)
    got = tdev.ImpactBM25.try_create(tr).top_k_batch(
        [_groups(tr, s) for s in specs], K + 1, op)
    assert len(got) == len(specs)
    for spec, g, w in zip(specs, got, want):
        host_rows, _ = tr.bm25_scores(_groups(tr, spec), op)
        assert len(g[0]) == min(K + 1, len(host_rows))
        if not spec and op == "AND":
            # no groups: the host answers no row and so does the port; the
            # reference's served program answers every doc with score 0
            assert len(w[0]) == K + 1
            continue
        _assert_same_topk(g, w, K, 1e-5)
    assert tdev.ImpactBM25.try_create(tr).top_k_batch([], K, op) == []


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["desc", "asc"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_impact_fused_matches_jax(readers, metric, sign):
    """``w_s * bm25 + w_d * dist`` over the text-matched docs; an ASC order
    negates both weights (the mask must still be -inf)."""
    jr, tr = readers
    ji, ti = jdev.ImpactBM25.try_create(jr), tdev.ImpactBM25.try_create(tr)
    rng = np.random.default_rng(3)
    d = 16
    emb = rng.standard_normal((ti.n_pad, d)).astype(np.float32)
    emb[ti.n_docs:] = 0.0
    if metric == "cosine":
        emb[:ti.n_docs] /= np.linalg.norm(emb[:ti.n_docs], axis=1,
                                          keepdims=True)
    specs = [["red"], ["red", "fox"], ["~red", "dog"], ["whale", "?"], []]
    Q = rng.standard_normal((len(specs), d)).astype(np.float32)
    w_s, w_d = sign * 0.04, sign * -1.0
    for op in ("OR", "AND"):
        want = ji.fused_top_k_batch([_groups(jr, s) for s in specs], K + 1,
                                    op, jnp.asarray(emb), Q, w_s, w_d, metric)
        got = ti.fused_top_k_batch([_groups(tr, s) for s in specs], K + 1,
                                   op, backend.to_device(emb), Q, w_s, w_d,
                                   metric)
        for spec, g, w in zip(specs, got, want):
            (gr, gs), (wr, ws) = g, w
            if not spec and op == "AND":
                # no groups: no row, as on the host (the reference's served
                # program ranks every doc)
                assert len(gr) == 0 and len(wr) == K + 1
                continue
            assert len(gr) == len(wr)
            np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(gr[:K], wr[:K])


@pytest.mark.parametrize("op", ["OR", "AND"])
@pytest.mark.parametrize("scorer", ["impact", "csr_batch", "csr_single"])
def test_equal_scores_rank_by_lowest_row_id(tie_readers, scorer, op):
    """Short texts tie by the thousand: the top k holds the lowest row ids
    of the best score class, in ascending order, as the host path ranks them
    (stable sort of ``reader.bm25_scores``)."""
    jr, tr = tie_readers
    specs = [["weather"], ["news", "google"], ["maps", "cat", "stock"]]
    groups = [_groups(tr, s) for s in specs]
    if scorer == "impact":
        got = tdev.ImpactBM25.try_create(tr).top_k_batch(groups, K, op)
        want = jdev.ImpactBM25.try_create(jr).top_k_batch(groups, K, op)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
    elif scorer == "csr_batch":
        got = tdev.DeviceBM25(tr).top_k_batch(groups, K, op)
    else:
        dev = tdev.DeviceBM25(tr)
        got = [dev.top_k(g, K, op) for g in groups]
    for g, (rows, scores) in zip(groups, got):
        h_rows, h_scores = tr.bm25_scores(g, op)
        order = np.lexsort((h_rows, -h_scores))[:K]
        assert len(np.unique(h_scores)) < len(h_scores)      # it does tie
        np.testing.assert_array_equal(rows, h_rows[order])
        np.testing.assert_allclose(scores, h_scores[order], rtol=1e-4)


def _numpy_scores(term_ids, sat, qterms, idf, qgroup, need, dist, w_s, w_d):
    """The formula, doc by doc and query by query: f32 products summed in
    f64, rounded to f32 once."""
    n, b = term_ids.shape[0], qterms.shape[0]
    out = np.full((b, n), -np.inf, np.float32)
    for q in range(b):
        for d in range(n):
            score = 0.0
            hit_groups = set()
            for j in range(qterms.shape[1]):
                s = np.nonzero(term_ids[d] == qterms[q, j])[0]
                if len(s):
                    score += float(np.float32(idf[q, j] * sat[d, s[0]]))
                    hit_groups.add(int(qgroup[q, j]))
            score = np.float32(score)
            if len(hit_groups) >= need[q]:
                out[q, d] = score if dist is None else np.float32(
                    np.float32(np.float32(w_s) * score)
                    + np.float32(np.float32(w_d) * dist[q, d]))
    return out


def _random_operands(rng, n_docs, n_pad, slots, b, m, g):
    """A layout that keeps the scorer's contract: a term at most once per
    doc, pad docs and pad slots -2, pad terms -1, a group's terms adjacent."""
    vocab = 2 * slots + 1
    term_ids = np.full((n_pad, slots), -2, np.int32)
    sat = np.zeros((n_pad, slots), np.float32)
    for d in range(n_docs):
        cnt = int(rng.integers(1, slots + 1))
        term_ids[d, :cnt] = np.sort(rng.choice(vocab, cnt, replace=False))
        sat[d, :cnt] = rng.uniform(0.5, 2.0, cnt)
    qterms = np.full((b, m), -1, np.int32)
    idf = np.zeros((b, m), np.float32)
    qgroup = np.full((b, m), -1, np.int32)
    need = np.ones(b, np.float32)
    for q in range(b):
        n_terms = int(rng.integers(1, m + 1))
        qterms[q, :n_terms] = rng.integers(0, vocab, n_terms)
        idf[q, :n_terms] = rng.uniform(0.1, 3.0, n_terms)
        qgroup[q, :n_terms] = np.sort(rng.integers(0, g, n_terms))
        if q % 2:
            need[q] = len(set(qgroup[q, :n_terms].tolist()))
    return term_ids, sat, qterms, idf, qgroup, need


@pytest.mark.parametrize("fused", [False, True], ids=["text", "fused"])
@pytest.mark.parametrize("slots,b,m,g", [(8, 1, 4, 4), (64, 5, 8, 8),
                                         (512, 2, 4, 4)])
def test_plain_scores_match_the_formula(slots, b, m, g, fused, monkeypatch):
    rng = np.random.default_rng(slots + b)
    n_docs, n_pad = 90, 96
    ops = _random_operands(rng, n_docs, n_pad, slots, b, m, g)
    dist = rng.standard_normal((b, n_pad)).astype(np.float32) if fused \
        else None
    w_s, w_d = (-0.04, 1.0) if fused else (1.0, 0.0)
    want = _numpy_scores(*ops, dist, w_s, w_d)
    term_ids, sat, qterms, idf, qgroup, need = ops
    qpack = impact_bm25.pack_query_terms(qterms, idf, qgroup)
    assert qpack.shape == (b, m, 4) and qpack.dtype == np.int32
    tensors = [torch.from_numpy(a) for a in (term_ids, sat, qpack, need)]
    assert torch.equal(impact_bm25.pack_query_terms(
        *(torch.from_numpy(a) for a in (qterms, idf, qgroup))), tensors[2])
    td = torch.from_numpy(dist) if fused else None
    got = impact_bm25.impact_bm25_scores(*tensors, dist=td, w_s=w_s, w_d=w_d)
    assert got.shape == (b, n_pad) and got.dtype == torch.float32
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isinf(got.numpy()[:, n_docs:]).all()        # pad docs
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6)
    # tiled over docs: the same answer through 7-doc tiles
    monkeypatch.setattr(impact_bm25, "PLAIN_BYTES", 4 * slots * b * 7)
    tiled = impact_bm25._impact_bm25_scores_plain(*tensors, td, w_s, w_d)
    assert tiled.numpy().tobytes() == got.numpy().tobytes()


def test_scores_wrapper_rejects_what_the_kernel_does_not_take():
    term_ids, sat, qterms, idf, qgroup, need = _random_operands(
        np.random.default_rng(0), 10, 16, 8, 2, 4, 4)
    ops = [torch.from_numpy(a) for a in (
        term_ids, sat, impact_bm25.pack_query_terms(qterms, idf, qgroup),
        need)]
    with pytest.raises(TypeError):
        impact_bm25.impact_bm25_scores(ops[0].long(), *ops[1:])
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_scores(ops[0], ops[1][:, :4], *ops[2:])
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_scores(ops[0], ops[1], ops[2][..., :3], ops[3])
    with pytest.raises(ValueError):
        impact_bm25.impact_bm25_scores(*ops, dist=torch.zeros(2, 15))
    assert impact_bm25.impact_bm25_scores.launches == 0   # CPU: plain version
