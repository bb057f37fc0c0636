"""Prepared ``match()`` and fused text+vector statements through both
SessionContexts (the reference's match and fused serving tests,
tests/test_serving_filtered.py, run on both packages).

The same seeded rows go into a databend_tpu context and a databend_tpu_torch
context (torch on the CPU, asked for by name); the size gate
``_MatchServer.DEVICE_MIN_DOCS`` is lowered to 0 in both, so both serve from
their device scorers. The port's served answer equals the JAX package's
served answer and the port's own generic (literal SQL) path: the same rows,
scores to rtol 1e-4 (host f64 BM25 against f32 device sums). Equal scores
rank by ascending row id on every path.
"""

import numpy as np
import pytest

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.service.prepared import _MatchServer as JaxMatch
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.index.inverted import device as tdev
from databend_tpu_torch.service.prepared import _MatchServer as TorchMatch
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing

WORDS = ["weather", "news", "google", "maps", "cat", "videos", "python",
         "flights", "hotels", "music"]
D = 16


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    """Statements on either SessionContext record spans in their package's
    process-wide ring; empty both after the module, so that a later test
    file on this worker (tests/test_explain_profile.py) reads only its own
    spans."""
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _rows(n, seed, words=WORDS, counts=(2, 6)):
    """``n`` texts of ``counts[0]`` to ``counts[1] - 1`` of ``words`` and
    unit-norm embeddings, from ``seed``."""
    rng = np.random.default_rng(seed)
    texts = [" ".join(np.array(words)[rng.integers(0, len(words),
                                                   rng.integers(*counts))])
             for _ in range(n)]
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return texts, emb


def _load(ctx, expr_mod, types_mod, name, texts, emb, rpb):
    n = len(texts)
    ctx.sql(f"CREATE TABLE {name} (id BIGINT, body VARCHAR, emb VECTOR({D})) "
            f"ROW_PER_BLOCK='{rpb}'")
    ctx.sql(f"CREATE INVERTED INDEX {name}_i ON {name}(body)")
    ctx.insert_block(name, expr_mod.DataBlock(
        ["id", "body", "emb"],
        [expr_mod.Column.from_numpy(np.arange(n, dtype=np.int64)),
         expr_mod.Column.from_pylist(texts, types_mod.String),
         expr_mod.Column.from_numpy(emb, types_mod.VectorType(D))]))


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    """Table ``mt``: 2,400 rows in 3 blocks. Table ``small``: 50 rows.
    Table ``under``: 1,999 rows in 2 blocks, one doc under the port's
    served-text gate."""
    texts, emb = _rows(2400, 5)
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load(ctx, e, ty, "mt", texts, emb, 1000)
        _load(ctx, e, ty, "small", texts[:50], emb[:50], 1000)
        _load(ctx, e, ty, "under", texts[:1999], emb[:1999], 1000)
    yield j, t, emb
    j.close()
    t.close()


@pytest.fixture
def served(monkeypatch):
    monkeypatch.setattr(JaxMatch, "DEVICE_MIN_DOCS", 0)
    monkeypatch.setattr(TorchMatch, "DEVICE_MIN_DOCS", 0)


def _vec(v):
    return "[" + ",".join(f"{x:.6f}" for x in v) + "]"


def _same(got, want):
    """The same rows; a trailing float column (score()) to rtol 1e-4."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    if got and isinstance(got[0][-1], float):
        np.testing.assert_allclose([r[-1] for r in got],
                                   [r[-1] for r in want], rtol=1e-4)
        got, want = [r[:-1] for r in got], [r[:-1] for r in want]
    assert got == want


def _engaged(ps, n_blocks=3):
    m = ps._match
    assert m is not None and m._snap_id is not None
    assert len(m._scorers) == n_blocks
    assert all(isinstance(s, tdev.ImpactBM25) for s in m._scorers)


MATCH_SQL = ("SELECT id, score() FROM mt WHERE match(body, {p}) "
             "ORDER BY score() DESC LIMIT 7")


@pytest.mark.parametrize("text", ["weather news", "python", "cat videos maps",
                                  "nosuchword", "weather nosuchword"])
def test_match_prepared_single(ctxs, served, text):
    j, t, _ = ctxs
    jp, tp = j.prepare(MATCH_SQL.format(p="?")), t.prepare(MATCH_SQL.format(p="?"))
    got = tp.execute(text).rows()
    _engaged(tp)
    _same(got, jp.execute(text).rows())
    _same(got, t.sql(MATCH_SQL.format(p=f"'{text}'")).rows())


@pytest.mark.parametrize("items", ["id", "id, score()", "*", "body, id AS i"])
def test_match_prepared_batch(ctxs, served, items):
    j, t, _ = ctxs
    sql = (f"SELECT {items} FROM mt WHERE match(body, {{p}}) "
           "ORDER BY score() DESC LIMIT 5")
    texts = ["weather", "news google", "hotels flights music", "nosuchword"]
    jp, tp = j.prepare(sql.format(p="?")), t.prepare(sql.format(p="?"))
    got = tp.execute_batch(texts)
    _engaged(tp)
    want = jp.execute_batch(texts)
    assert len(got) == len(texts)
    for text, g, w in zip(texts, got, want):
        if items == "*":       # vector cells compare as lists
            assert [r[:2] for r in g.rows()] == [r[:2] for r in w.rows()]
            continue
        _same(g.rows(), w.rows())
        _same(g.rows(), t.sql(sql.format(p=f"'{text}'")).rows())
    assert [f.name for f in got[0].fields] == [f.name for f in want[0].fields]


@pytest.mark.parametrize("opts", ["operator=AND", "fuzziness=1",
                                  "fuzziness=1;operator=AND"])
def test_match_options(ctxs, served, opts):
    j, t, _ = ctxs
    sql = (f"SELECT id FROM mt WHERE match(body, {{p}}, '{opts}') "
           "ORDER BY score() DESC LIMIT 5")
    jp, tp = j.prepare(sql.format(p="?")), t.prepare(sql.format(p="?"))
    for text in ("weather news", "hotel musix"):
        got = tp.execute(text).rows()
        _engaged(tp)
        _same(got, jp.execute(text).rows())
        _same(got, t.sql(sql.format(p=f"'{text}'")).rows())


def test_match_phrase_falls_back(ctxs, served):
    j, t, _ = ctxs
    sql = ("SELECT id FROM mt WHERE match(body, {p}) "
           "ORDER BY score() DESC LIMIT 5")
    tp = t.prepare(sql.format(p="?"))
    assert not tp._match.can_serve_texts(['"weather news"'])
    got = tp.execute('"weather news"').rows()
    _same(got, j.prepare(sql.format(p="?")).execute('"weather news"').rows())
    _same(got, t.sql(sql.format(p="'\"weather news\"'")).rows())


def test_match_below_device_threshold_uses_generic(ctxs):
    j, t, _ = ctxs
    sql = ("SELECT id FROM {tb} WHERE match(body, {p}) "
           "ORDER BY score() DESC LIMIT 3")
    assert TorchMatch.DEVICE_MIN_DOCS == 2_000
    assert JaxMatch.DEVICE_MIN_DOCS == 20_000
    for tb in ("small", "under"):
        tp = t.prepare(sql.format(tb=tb, p="?"))
        got = tp.execute("weather").rows()
        assert not tp._match.refresh() and tp._match._snap_id is None
        _same(got, t.sql(sql.format(tb=tb, p="'weather'")).rows())
        _same(got, j.prepare(sql.format(tb=tb, p="?")).execute("weather").rows())


def test_match_sees_new_rows(tmp_path, served):
    """A new snapshot rebuilds the serving state."""
    t = TorchContext(str(tmp_path / "torch"))
    try:
        texts, emb = _rows(300, 7)
        _load(t, texpr, ttypes, "mt", texts, emb, 1000)
        sql = ("SELECT id FROM mt WHERE match(body, {p}) "
               "ORDER BY score() DESC LIMIT 400")
        tp = t.prepare(sql.format(p="?"))
        before = tp.execute("weather").rows()
        snap = tp._match._snap_id
        t.sql("INSERT INTO mt VALUES (9000, 'weather weather weather', "
              + _vec(emb[0]) + ")")
        after = tp.execute("weather").rows()
        assert tp._match._snap_id != snap and len(tp._match._scorers) == 2
        assert len(after) == len(before) + 1 and (9000,) in after
        _same(after, t.sql(sql.format(p="'weather'")).rows())
    finally:
        t.close()


FUSED = [
    ("cosine_distance", "0.04 * score() - cosine_distance(emb, {p})", "DESC"),
    ("cosine_distance", "cosine_distance(emb, {p}) - 0.04 * score()", "ASC"),
    ("l2_distance", "0.1 * score() - l2_distance(emb, {p})", "DESC"),
    ("l2_distance", "l2_distance(emb, {p}) - 0.1 * score()", "ASC"),
]


@pytest.mark.parametrize("fn,order,direction", FUSED,
                         ids=[f"{f[0][:-9]}-{f[2]}" for f in FUSED])
def test_fused_single_and_batch(ctxs, served, fn, order, direction):
    j, t, emb = ctxs
    sql = ("SELECT id FROM mt WHERE match(body, {t}) ORDER BY " + order
           + f" {direction} LIMIT 6")
    jp = j.prepare(sql.format(t="?", p="?"))
    tp = t.prepare(sql.format(t="?", p="?"))
    assert tp._match is not None and tp._match.shape.fused
    rng = np.random.default_rng(1)
    qs = [(text, emb[rng.integers(0, len(emb))]
           + 0.05 * rng.standard_normal(D).astype(np.float32))
          for text in ("weather news", "cat", "python maps", "nosuchword")]
    sets = [(text, list(map(float, v))) for text, v in qs]
    got = tp.execute_batch(sets)
    _engaged(tp)
    assert len(tp._match._embs) == 3 and tp._match._embs[0].shape[1] == D
    want = jp.execute_batch(sets)
    for (text, v), g, w in zip(qs, got, want):
        _same(g.rows(), w.rows())
        _same(g.rows(), t.sql(sql.format(t=f"'{text}'", p=_vec(v))).rows())
    _same(tp.execute(*sets[0]).rows(), got[0].rows())


def test_fused_rejects_what_it_cannot_serve(ctxs, served):
    _, t, emb = ctxs
    tp = t.prepare("SELECT id FROM mt WHERE match(body, ?) ORDER BY "
                   "0.04 * score() - cosine_distance(emb, ?) DESC LIMIT 6")
    m = tp._match
    assert m.extract_batch([("weather",)], 2) is None          # arity
    assert m.extract_batch([(3, [0.0] * D)], 2) is None        # text type
    assert m.can_serve_texts(["weather"])
    assert m.run_batch(["weather"], None) is None              # no vectors
    assert m.run_batch(["weather"], np.zeros((1, D + 1), np.float32)) is None
    # a literal SQL statement of the same shape still answers
    good = tp.execute("weather", list(map(float, emb[0]))).rows()
    assert len(good) == 6


def test_serving_keeps_dispatch_then_collect_order(ctxs, served, monkeypatch):
    """Every block is dispatched before the first collect."""
    _, t, _ = ctxs
    tp = t.prepare(MATCH_SQL.format(p="?"))
    events = []
    real_d = tdev.ImpactBM25.dispatch_top_k_batch
    real_c = tdev.ImpactBM25.collect
    monkeypatch.setattr(tdev.ImpactBM25, "dispatch_top_k_batch",
                        lambda self, *a: events.append("d") or real_d(self, *a))
    monkeypatch.setattr(tdev.ImpactBM25, "collect",
                        lambda self, h: events.append("c") or real_c(self, h))
    tp.execute_batch(["weather", "news"])
    assert events == ["d", "d", "d", "c", "c", "c"]
