"""Served BM25 against the generic path where scores tie, and token-free
AND queries, through both SessionContexts on the CPU.

Table ``mt``: 2,400 rows in 3 blocks, texts of 1-6 words drawn from 14 (the
four one-letter words among them), seed 5. Many docs hold different words of
equal document frequency, so their BM25 contributions are the same set of
(idf, saturation) products in different query positions: rows 1207 (``a
maps c google python``) and 1612 (``d c a google python``) under ``a b c d
weather news google maps cat videos python`` are one such pair. Table
``lt``: the same rows and one doc of 600 distinct words, so the block that
holds it is served by the CSR scorer ``DeviceBM25`` (``ImpactBM25`` takes
at most 512 terms a doc) and the other two by ``ImpactBM25``.

With ``_MatchServer.DEVICE_MIN_DOCS`` lowered to 0 in both packages, the
port's served rows equal its own generic (literal SQL) statement's and the
JAX package's generic statement's: equal scores rank by ascending row id,
scores to rtol 1e-4 (the host's f64 BM25 against f32 products summed in
f64). The JAX package's served path is no truth here: it sums in f32 in
query order, and its CSR scorer has no batch dispatch.
"""

import numpy as np
import pytest
import torch

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch.index.inverted import device as tdev
from databend_tpu_torch.ops import impact_bm25
from databend_tpu_torch.service.session import SessionContext as TorchContext

from test_torch_match_serving import (  # noqa: F401  (fixtures)
    D, _drain_span_rings, _load, _rows, _same, _torch_on_cpu, _vec, served)

PROBE_WORDS = ["weather", "news", "google", "maps", "cat", "videos",
               "python", "flights", "hotels", "music", "a", "b", "c", "d"]
WORKED = "a b c d weather news google maps cat videos python"
LONG_DOC = " ".join(f"w{i}" for i in range(600))
TERMS = (6, 8, 11, 14)
TEXT_SQL = ("SELECT id, score() FROM {tb} WHERE match(body, {p}) "
            "ORDER BY score() DESC LIMIT {k}")
FUSED_SQL = ("SELECT id FROM mt WHERE match(body, {t}) ORDER BY "
             "0.04 * score() - cosine_distance(emb, {p}) DESC LIMIT {k}")


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    """Both packages' contexts on ``mt`` and ``lt`` (see the module doc)."""
    texts, emb = _rows(2400, 5, PROBE_WORDS, (1, 7))
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    long_emb = np.concatenate([emb, emb[:1]])
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load(ctx, e, ty, "mt", texts, emb, 1000)
        _load(ctx, e, ty, "lt", texts + [LONG_DOC], long_emb, 1000)
    yield j, t, emb
    j.close()
    t.close()


def _queries(n_terms, count=4):
    """``count`` queries of ``n_terms`` distinct probe words, seeded by
    their length."""
    rng = np.random.default_rng(n_terms)
    return [" ".join(rng.choice(PROBE_WORDS, n_terms, replace=False))
            for _ in range(count)]


def _generic(j, t, sql):
    """The port's generic rows, held to the JAX package's generic rows."""
    want = t.sql(sql).rows()
    _same(want, j.sql(sql).rows())
    return want


def _scorers(tp, kinds):
    m = tp._match
    assert m is not None and m._snap_id is not None
    assert [type(s) for s in m._scorers] == kinds


@pytest.mark.parametrize("mode", ["execute", "execute_batch"])
@pytest.mark.parametrize("tb", ["mt", "lt"])
def test_served_text_ties_rank_as_generic(ctxs, served, tb, mode):
    """6-14 terms at LIMIT 128: the served rows are the generic rows."""
    j, t, _ = ctxs
    texts = [WORKED] + [q for n in TERMS for q in _queries(n)]
    tp = t.prepare(TEXT_SQL.format(tb=tb, p="?", k=128))
    if mode == "execute":
        got = [tp.execute(text).rows() for text in texts]
    else:
        got = [r.rows() for r in tp.execute_batch(texts)]
    impact = tdev.ImpactBM25
    _scorers(tp, [impact] * 3 if tb == "mt"
             else [impact, impact, tdev.DeviceBM25])
    for text, rows in zip(texts, got):
        _same(rows, _generic(j, t, TEXT_SQL.format(tb=tb, p=f"'{text}'",
                                                   k=128)))
    worked = [r[0] for r in got[0]]
    assert worked.index(1207) < worked.index(1612)


@pytest.mark.parametrize("mode", ["execute", "execute_batch"])
def test_served_fused_ties_rank_as_generic(ctxs, served, mode):
    j, t, emb = ctxs
    rng = np.random.default_rng(3)
    texts = [WORKED] + [q for n in TERMS for q in _queries(n, 2)]
    sets = [(text, list(map(float, emb[rng.integers(0, len(emb))]
                            + 0.05 * rng.standard_normal(D))))
            for text in texts]
    tp = t.prepare(FUSED_SQL.format(t="?", p="?", k=128))
    if mode == "execute":
        got = [tp.execute(*s).rows() for s in sets]
    else:
        got = [r.rows() for r in tp.execute_batch(sets)]
    assert tp._match.shape.fused
    _scorers(tp, [tdev.ImpactBM25] * 3)
    for (text, v), rows in zip(sets, got):
        _same(rows, _generic(j, t, FUSED_SQL.format(t=f"'{text}'", p=_vec(v),
                                                    k=128)))


def test_device_bm25_ties_rank_as_generic(ctxs, served):
    """The CSR scorer alone on ``lt``'s last block: every doc of a 6-14
    term query, ranked as the host's f64 BM25 ranks it."""
    _, t, _ = ctxs
    from databend_tpu_torch.index.inverted.tokenizer import tokenize_text
    tp = t.prepare(TEXT_SQL.format(tb="lt", p="?", k=10))
    m = tp._match
    assert m.refresh()
    reader, scorer = m._readers[2], m._scorers[2]
    assert isinstance(scorer, tdev.DeviceBM25) and reader.n_docs == 401
    texts = [WORKED] + [q for n in TERMS for q in _queries(n)]
    groups = [[[reader.term_id(w)] for w in tokenize_text(
        text, reader.tokenizer, reader.filters)] for text in texts]
    got = scorer.top_k_batch(groups, reader.n_docs)
    for tg, (rows, vals), text in zip(groups, got, texts):
        want_rows, want_vals = reader.bm25_scores(tg)
        order = np.lexsort((want_rows, -want_vals))
        assert rows.tolist() == want_rows[order].tolist(), text
        np.testing.assert_allclose(vals, want_vals[order], rtol=1e-4)
        single_rows, single_vals = scorer.top_k(tg, reader.n_docs)
        assert single_rows.tolist() == rows.tolist()
        assert single_vals.tobytes() == vals.tobytes()
        dense_rows, dense_vals = scorer.score(tg)
        assert dense_rows.tolist() == sorted(rows.tolist())
        assert dense_vals[np.searchsorted(dense_rows, rows)].tobytes() \
            == vals.tobytes()


def test_plain_sum_depends_on_the_set_of_products():
    """Docs 5 and 2 match the same products {1, 3e-8, 3e-8} at query
    positions 0-2 and 3-5 (1 = 2 * 0.5 = 0.25 * 4): in f32 in term order
    they would sum to 1 and 1 + 2^-23. They get equal bits, and doc 2
    ranks first; doc 7 (1 alone) ranks last."""
    n_pad, slots = 16, 8
    term_ids = np.full((n_pad, slots), -2, np.int32)
    sat = np.zeros((n_pad, slots), np.float32)
    term_ids[5, :3], sat[5, :3] = (10, 11, 12), (0.5, 3e-8, 3e-8)
    term_ids[2, :3], sat[2, :3] = (13, 14, 15), (3e-8, 3e-8, 4.0)
    term_ids[7, :1], sat[7, :1] = (10,), (0.5,)
    qterms = np.array([[10, 11, 12, 13, 14, 15, -1, -1]], np.int32)
    idf = np.array([[2.0, 1.0, 1.0, 1.0, 1.0, 0.25, 0, 0]], np.float32)
    qgroup = np.array([[0, 1, 2, 3, 4, 5, -1, -1]], np.int32)
    ops = [torch.from_numpy(a) for a in (
        term_ids, sat, impact_bm25.pack_query_terms(qterms, idf, qgroup),
        np.ones(1, np.float32))]
    scores = impact_bm25._impact_bm25_scores_plain(*ops)[0]
    want = np.float32(1.0) + np.float32(2.0 ** -23)
    assert scores[5].item() == scores[2].item() == want
    assert scores[7].item() == 1.0
    vals, ids = impact_bm25._impact_bm25_topk_plain(*ops, 3)
    assert ids[0].tolist() == [2, 5, 7]
    assert vals[0].numpy().tobytes() == np.array(
        [want, want, 1.0], np.float32).tobytes()


TOKEN_FREE = ["", "   ", "!!"]


@pytest.mark.parametrize("op", ["AND", "OR"])
@pytest.mark.parametrize("tb", ["mt", "lt"])
def test_token_free_query_matches_nothing(ctxs, served, tb, op):
    """A text with no token answers no row, alone and in a batch, as the
    generic path answers it; the batch's other queries are unchanged."""
    j, t, _ = ctxs
    sql = (f"SELECT id, score() FROM {tb} WHERE match(body, {{p}}, "
           f"'operator={op}') ORDER BY score() DESC LIMIT 5")
    tp = t.prepare(sql.format(p="?"))
    batch = TOKEN_FREE + ["weather news"]
    got = tp.execute_batch(batch)
    for text, res in zip(batch, got):
        want = _generic(j, t, sql.format(p=f"'{text}'"))
        assert len(want) == (5 if text.strip("! ") else 0)
        _same(res.rows(), want)
        _same(tp.execute(text).rows(), want)
    assert tp._match._snap_id is not None


@pytest.mark.parametrize("op", ["AND", "OR"])
def test_token_free_fused_query_matches_nothing(ctxs, served, op):
    j, t, emb = ctxs
    sql = (f"SELECT id FROM mt WHERE match(body, {{t}}, 'operator={op}') "
           "ORDER BY 0.04 * score() - cosine_distance(emb, {p}) DESC LIMIT 5")
    tp = t.prepare(sql.format(t="?", p="?"))
    sets = [(text, list(map(float, emb[i])))
            for i, text in enumerate(TOKEN_FREE + ["weather news"])]
    got = tp.execute_batch(sets)
    assert tp._match.shape.fused and tp._match._snap_id is not None
    for (text, v), res in zip(sets, got):
        want = _generic(j, t, sql.format(t=f"'{text}'", p=_vec(v)))
        assert len(want) == (5 if text.strip("! ") else 0)
        _same(res.rows(), want)
        _same(tp.execute(text, v).rows(), want)


@pytest.mark.parametrize("op", ["AND", "OR"])
def test_scorers_drop_a_query_without_groups(ctxs, served, op):
    """Both scorers, called directly: a query of no groups gets no row
    beside a query that matches."""
    _, t, _ = ctxs
    m = t.prepare(TEXT_SQL.format(tb="lt", p="?", k=5))._match
    assert m.refresh()
    for reader, scorer in zip(m._readers[1:], m._scorers[1:]):
        word = [[reader.term_id("weather")]]
        got = scorer.top_k_batch([[], word, []], 5, op)
        assert [len(r) for r, _ in got] == [0, 5, 0]
        assert [len(r) for r, _ in scorer.top_k_batch([[]], 5, op)] == [0]
