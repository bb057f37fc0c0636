"""The exact-KNN serving slice through both SessionContexts.

One seed builds the same table in a databend_tpu context and in a
databend_tpu_torch context (torch on the CPU, asked for by name). With
``vector_host_scan_max_rows = 0`` every vector query takes the device path.
Exact modes: the same rows, scores to rtol 1e-5 (f32 sums in different
orders). Approximate mode: the port runs the flash group-min scan, JAX runs
approx_min_k (an exact top-k on the CPU backend): recall >= 0.95 against
JAX's answer, and the shared ids' scores to rtol 1e-5.
"""

import numpy as np
import pytest

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.catalog.pushdown import VectorIndexInfo as JaxInfo
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.catalog.pushdown import VectorIndexInfo as TorchInfo
from databend_tpu_torch.ops import flash_topk as tflash
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.storage.fuse import table as ttable
from databend_tpu_torch.utils.cache import CacheManager
from databend_tpu_torch.utils import tracing as ttracing

N, D, SEED = 6000, 24, 11


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


def _data(n=N, d=D, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.integers(0, n, size=300)] \
        + 0.1 * rng.standard_normal((300, d)).astype(np.float32)
    return x, q


def _load(ctx, expr_mod, types_mod, x, rpb=4096):
    n, d = x.shape
    ctx.sql(f"CREATE TABLE t (id BIGINT, emb VECTOR({d})) "
            f"ROW_PER_BLOCK='{rpb}'")
    ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2,cosine'")
    ctx.insert_block("t", expr_mod.DataBlock(
        ["id", "emb"],
        [expr_mod.Column.from_numpy(np.arange(n, dtype=np.int64)),
         expr_mod.Column.from_numpy(x, types_mod.VectorType(d))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    x, q = _data()
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    _load(j, jexpr, jtypes, x)
    _load(t, texpr, ttypes, x)
    yield j, t, q
    j.close()
    t.close()


def _lit(v):
    return "[" + ",".join(f"{f:.6f}" for f in v) + "]"


def _same_rows(got, want):
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    np.testing.assert_allclose([r[-1] for r in got], [r[-1] for r in want],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_literal_knn_matches_jax(ctxs, fn, monkeypatch):
    j, t, q = ctxs
    calls = []
    real = ttable._exact_topk_program
    monkeypatch.setattr(ttable, "_exact_topk_program",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for v in q[:3]:
        # the vector rewrite: pruner -> batch_exact_topk on the device
        sql = f"SELECT id FROM t ORDER BY {fn}(emb, {_lit(v)}) LIMIT 10"
        assert t.sql(sql).rows() == j.sql(sql).rows()
        # a selected score: the SQL function over whole blocks
        sql = (f"SELECT id, {fn}(emb, {_lit(v)}) AS d FROM t "
               f"ORDER BY {fn}(emb, {_lit(v)}) LIMIT 10")
        _same_rows(t.sql(sql).rows(), j.sql(sql).rows())
    assert len(calls) == 3          # the device scan served every rewrite


def test_literal_filtered_knn_matches_jax(ctxs):
    j, t, q = ctxs
    sql = (f"SELECT id, l2_distance(emb, {_lit(q[5])}) AS d FROM t "
           f"WHERE id < 3000 ORDER BY l2_distance(emb, {_lit(q[5])}) LIMIT 10")
    _same_rows(t.sql(sql).rows(), j.sql(sql).rows())


def test_literal_l1_rowwise_matches_jax(ctxs):
    """No l1 index: the SQL function scores whole blocks (the device branch
    of vector_fns._rowwise for the 4096-row block)."""
    j, t, q = ctxs
    sql = (f"SELECT id, l1_distance(emb, {_lit(q[7])}) AS d FROM t "
           f"ORDER BY d LIMIT 10")
    _same_rows(t.sql(sql).rows(), j.sql(sql).rows())


def _blocks(table):
    return [m for seg in table.read_segments(table.read_snapshot())
            for m in seg.blocks]


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance",
                                "l1_distance"])
def test_table_device_seams_match_jax(ctxs, fn):
    """FuseTable's device seams one by one: the per-block scan of a
    quantum-padded block (1904 real rows on a 4096-row device array), the
    pruned-subset and stacked forms of batch_exact_topk, and
    batch_generate_scores."""
    j, t, q = ctxs
    jt, tt = j.table("t"), t.table("t")
    jm, tm = _blocks(jt), _blocks(tt)
    assert [m.row_count for m in tm] == [4096, 1904]
    jinfo = JaxInfo("tv", "emb", fn, q[9].tolist())
    tinfo = TorchInfo("tv", "emb", fn, q[9].tolist())
    jv, ji = jt.brute_force_block_scores(jm[1], jinfo, q[9:10], 10)
    tv, ti = tt.brute_force_block_scores(tm[1], tinfo, q[9:10], 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    for sub in ([1], [0, 1]):        # pruned subset, then the stacked set
        want = jt.batch_exact_topk([jm[i] for i in sub], jinfo, q[9:10], 10)
        got = tt.batch_exact_topk([tm[i] for i in sub], tinfo, q[9:10], 10)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                                   rtol=1e-5, atol=1e-6)
        for g, w in zip(tt.batch_generate_scores([tm[i] for i in sub], tinfo),
                        jt.batch_generate_scores([jm[i] for i in sub], jinfo)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _prepared(ctx, fn):
    return ctx.prepare(f"SELECT id, {fn}(emb, ?) AS d FROM t "
                       f"ORDER BY {fn}(emb, ?) LIMIT 10")


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_execute_batch_exact_matches_jax(ctxs, fn):
    j, t, q = ctxs
    sets = [(v, v) for v in q[:20]]
    got = _prepared(t, fn).execute_batch(sets, exact=True)
    want = _prepared(j, fn).execute_batch(sets, exact=True)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        _same_rows(g.rows(), w.rows())
    _same_rows(_prepared(t, fn).execute(q[0], q[0]).rows(), want[0].rows())


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_execute_batch_block_exact_matches_jax(ctxs, fn):
    j, t, q = ctxs                  # 300 queries: two chunks of the scan
    sets = [(v, v) for v in q]
    _same_rows(_prepared(t, fn).execute_batch_block(sets, exact=True).rows(),
               _prepared(j, fn).execute_batch_block(sets, exact=True).rows())


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_execute_batch_block_approx_recall(ctxs, fn, monkeypatch):
    j, t, q = ctxs
    sets = [(v, v) for v in q]
    calls = []
    real = tflash.flash_group_minima
    monkeypatch.setattr(tflash, "flash_group_minima",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _prepared(t, fn).execute_batch_block(sets, exact=False).rows()
    assert len(calls) == 2          # the flash scan, once per query chunk
    want = _prepared(j, fn).execute_batch_block(sets, exact=False).rows()
    assert len(got) == len(want) == 300 * 10
    gd = {(qi, rid): s for qi, rid, s in got}
    wd = {(qi, rid): s for qi, rid, s in want}
    shared = gd.keys() & wd.keys()
    assert len(shared) / len(wd) >= 0.95
    keys = sorted(shared)
    np.testing.assert_allclose([gd[k] for k in keys], [wd[k] for k in keys],
                               rtol=1e-5, atol=1e-6)


def test_flash_state_is_lazy_and_shared(tmp_path):
    """Exact serving builds no flash state; the first approximate call on a
    snapshot builds one, which every statement over that snapshot and
    column shares (the normalized cosine corpus has its own)."""
    x, q = _data(n=3000, seed=13)
    t = TorchContext(str(tmp_path))
    _load(t, texpr, ttypes, x, rpb=1024)
    cached = CacheManager.instance().vector_columns._d
    sets = [(v, v) for v in q]       # two chunks: approximate runs flash
    try:
        a, b = _prepared(t, "l2_distance"), _prepared(t, "l2_distance")
        a.execute_batch_block(sets, exact=True)
        key = ("flash",) + a._knn._corpus_key
        assert key not in cached
        a.execute_batch_block(sets, exact=False)
        b.execute_batch_block(sets, exact=False)
        assert key in cached
        assert a._knn._flash_state() is b._knn._flash_state()
        c = _prepared(t, "cosine_distance")
        c.execute_batch_block(sets, exact=False)
        assert ("flash",) + c._knn._corpus_key != key
        assert c._knn._flash_state()[0] is not a._knn._flash_state()[0]
    finally:
        t.close()


@pytest.mark.parametrize("exact", [True, False])
def test_filtered_prepared_matches_jax(ctxs, exact):
    """``WHERE id < ?`` per query; id < 4 leaves fewer than k rows.
    The port's filtered approximate mode is exact, so JAX's (exact on the
    CPU) answer must match row for row."""
    j, t, q = ctxs
    sql = ("SELECT id, l2_distance(emb, ?) AS d FROM t WHERE id < ? "
           "ORDER BY l2_distance(emb, ?) LIMIT 10")
    sets = [(v, lim, v) for v, lim in zip(q[:6], [4, 100, 1000, 3000, 5999, 6000])]
    got = t.prepare(sql).execute_batch(sets, exact=exact)
    want = j.prepare(sql).execute_batch(sets, exact=exact)
    assert len(got[0].rows()) == 4
    for g, w in zip(got, want):
        _same_rows(g.rows(), w.rows())


def test_port_reads_jax_data_root(tmp_path):
    """The Fuse files are the state both packages share: a table the JAX
    package wrote answers the same KNN query through the port."""
    x, q = _data(n=3000, seed=12)
    root = str(tmp_path / "shared")
    j = JaxContext(root)
    _load(j, jexpr, jtypes, x, rpb=1024)
    sql = (f"SELECT id, l2_distance(emb, {_lit(q[0])}) AS d FROM t "
           f"ORDER BY l2_distance(emb, {_lit(q[0])}) LIMIT 10")
    want = j.sql(sql).rows()
    j.close()
    t = TorchContext(root)
    t.sql("SET vector_host_scan_max_rows = 0")
    try:
        _same_rows(t.sql(sql).rows(), want)
    finally:
        t.close()


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance"])
def test_execute_batch_block_one_chunk_approx_is_exact(ctxs, fn, monkeypatch):
    """A batch of one 256-query chunk runs the exact program in both modes,
    as the reference's ``_topk`` does: JAX's rows and scores, no flash
    scan."""
    j, t, q = ctxs
    sets = [(v, v) for v in q[:200]]
    calls = []
    real = tflash.flash_group_minima
    monkeypatch.setattr(tflash, "flash_group_minima",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _prepared(t, fn).execute_batch_block(sets, exact=False).rows()
    assert calls == []
    want = _prepared(j, fn).execute_batch_block(sets, exact=False).rows()
    assert len(got) == 200 * 10
    _same_rows(got, want)


def _text_table(ctx, expr_mod, types_mod, n=600, seed=5):
    words = np.array(["weather", "news", "google", "maps", "cat", "videos",
                      "python", "flights", "hotels", "music"])
    rng = np.random.default_rng(seed)
    texts = [" ".join(words[rng.integers(0, len(words), rng.integers(2, 6))])
             for _ in range(n)]
    ctx.sql("CREATE TABLE mt (id BIGINT, body VARCHAR)")
    ctx.sql("CREATE INVERTED INDEX mt_i ON mt(body)")
    ctx.insert_block("mt", expr_mod.DataBlock(
        ["id", "body"],
        [expr_mod.Column.from_numpy(np.arange(n, dtype=np.int64)),
         expr_mod.Column.from_pylist(texts, types_mod.String)]))


def test_prepared_match_matches_jax(tmp_path, monkeypatch):
    """A prepared BM25 ``match()`` statement above the size gate (lowered to
    0 in both packages): both serve it from their device scorers; the same
    rows and scores. Below the gate the port declines to the generic path."""
    from databend_tpu.service.prepared import _MatchServer as JaxMatch
    from databend_tpu_torch.service.prepared import _MatchServer as TorchMatch
    monkeypatch.setattr(JaxMatch, "DEVICE_MIN_DOCS", 0)
    j = JaxContext(str(tmp_path / "jax"))
    t = TorchContext(str(tmp_path / "torch"))
    try:
        _text_table(j, jexpr, jtypes)
        _text_table(t, texpr, ttypes)
        sql = ("SELECT id, score() FROM mt WHERE match(body, ?) "
               "ORDER BY score() DESC LIMIT 7")
        jp, tp = j.prepare(sql), t.prepare(sql)
        assert TorchMatch.DEVICE_MIN_DOCS == 2_000
        assert tp._match is not None and not tp._match.refresh()
        monkeypatch.setattr(TorchMatch, "DEVICE_MIN_DOCS", 0)
        assert tp._match.refresh() and tp._match._snap_id is not None
        assert all(s is not None for s in tp._match._scorers)
        texts = ["weather news", "python", "cat videos maps"]
        for g, w in zip(tp.execute_batch(texts), jp.execute_batch(texts)):
            _same_rows(g.rows(), w.rows())
        _same_rows(tp.execute("hotels").rows(), jp.execute("hotels").rows())
    finally:
        j.close()
        t.close()


def test_multi_card_host_answers_on_one(ctxs, monkeypatch):
    """With several cards visible the port still answers a device-path KNN
    query (the mesh-sharded prune is not ported), with JAX's rows."""
    import torch
    j, t, q = ctxs
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    t.sql("SET vector_host_scan_max_rows = 0")
    sql = f"SELECT id FROM t ORDER BY l2_distance(emb, {_lit(q[11])}) LIMIT 10"
    assert t.sql(sql).rows() == j.sql(sql).rows()
