"""Exact KNN on tied distances: the port keeps the reference's tie order.

The reference selects with ``jax.lax.top_k(-d, k)``: among equal distances
it keeps the lowest row ids, in ascending order. On an integer corpus (5,000
x 8 integers in [0, 3], from a seed) distances tie by the hundred, so every
exact path must return the JAX package's ids in the JAX package's order:
the literal statement, ``execute_batch(exact=True)``,
``execute_batch_block(exact=True)``, the filtered batch, and the
``ops.topk`` selectors, each for l2 and cosine (a zero query under cosine
too: every distance is 1). Both SessionContexts run with
``vector_host_scan_max_rows = 0``, so every statement takes the device path
(torch on the CPU, asked for by name).

The ties must be the same ties in both packages, so every distance must be
exact in f32. l2 over integers is. A cosine is exact only where the
normalised rows are: the cosine table keeps the integer rows in [0, 3] whose
squared norm is 1, 4 or 16 (a norm that is a power of two). Over the whole
[0, 3] corpus the two packages' f32 matrix products round apart (about a
quarter of a query's cosines differ by an ulp between XLA's CPU dot and
torch's), which orders rows that tie in exact arithmetic differently whatever
the selection; there the port is held to ``lax.top_k`` over its own
distances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.ops import topk as jtopk
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.ops import topk as ttopk
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing

N, D, SEED = 5000, 8, 5


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


def _exact_norm(rows):
    """The rows whose squared norm is 1, 4 or 16."""
    return rows[np.isin((rows ** 2).sum(1), (1, 4, 16))]


def _data():
    """(table name -> corpus, queries), the filter column. ``t``: integers
    in [0, 3]; ``c``: the same draw's rows of a power-of-two norm, resampled
    to N rows (duplicates tie under every metric), and a zero query."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 4, (N, D)).astype(np.float32)
    q = rng.integers(0, 4, (40, D)).astype(np.float32)
    pool = _exact_norm(rng.integers(0, 4, (200_000, D)).astype(np.float32))
    xc = pool[rng.integers(0, len(pool), N)]
    qc = pool[rng.integers(0, len(pool), 40)]
    qc[0] = 0.0                    # every cosine distance is 1
    price = rng.integers(0, 100, N).astype(np.int64)
    return {"t": (x, q), "c": (xc, qc)}, price


def _load(ctx, e, ty, tables, price):
    for name, (x, _) in tables.items():
        ctx.sql(f"CREATE TABLE {name} (id BIGINT, price BIGINT, "
                f"emb VECTOR({D})) ROW_PER_BLOCK='4096'")
        ctx.sql(f"CREATE VECTOR INDEX {name}v ON {name}(emb) "
                "distance='l2,cosine'")
        ctx.insert_block(name, e.DataBlock(
            ["id", "price", "emb"],
            [e.Column.from_numpy(np.arange(N, dtype=np.int64)),
             e.Column.from_numpy(price),
             e.Column.from_numpy(x, ty.VectorType(D))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    tables, price = _data()
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    _load(j, jexpr, jtypes, tables, price)
    _load(t, texpr, ttypes, tables, price)
    yield j, t, tables
    j.close()
    t.close()


# (distance function, table): l2 over the whole integer corpus, cosine over
# the rows whose cosines are exact (module docstring)
CASES = [("l2_distance", "t"), ("cosine_distance", "c"),
         ("l2_distance", "c")]
# the two ways ops.topk.topk_smallest_lowest_index selects: a stable sort of
# rows of at most SORT_MAX_N distances (the corpus's 5,000), a top-(k+1)
# and the tied rows' second selection above it
PATHS = {"sort": None, "topk": 0}


@pytest.fixture(params=list(PATHS))
def path(request, monkeypatch):
    if PATHS[request.param] is not None:
        monkeypatch.setattr(ttopk, "SORT_MAX_N", PATHS[request.param])
    return request.param


def _lit(v):
    return "[" + ",".join(f"{f:.1f}" for f in v) + "]"


def _ids(rows):
    return [r[0] for r in rows]


def test_corpus_ties_across_the_tenth_place():
    """The data has what the test is for: most queries tie at rank 10."""
    tables, _ = _data()
    for x, q in tables.values():
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        kth = np.sort(d, 1)[:, 9:10]
        assert ((d == kth).sum(1) > 1).mean() > 0.9


@pytest.mark.parametrize("fn,table", CASES)
def test_literal_statement_ids_equal_jax(ctxs, fn, table, path):
    j, t, tables = ctxs
    for v in tables[table][1][:20]:
        sql = (f"SELECT id FROM {table} ORDER BY {fn}(emb, {_lit(v)}) "
               "LIMIT 10")
        assert _ids(t.sql(sql).rows()) == _ids(j.sql(sql).rows()), sql


def test_literal_cosine_takes_the_tie_rule_on_its_own_distances(ctxs):
    """The whole [0, 3] corpus under cosine: the port's ids are
    ``lax.top_k(-d)`` of the port's own distances."""
    import jax

    from databend_tpu_torch.ops.distance import normalize, pairwise_distance

    _, t, tables = ctxs
    x, q = tables["t"]
    xn = normalize(torch.from_numpy(x))
    for v in q[:20]:
        d = pairwise_distance(torch.from_numpy(v[None]), xn, "cosine",
                              x_normalized=True).numpy()
        want = np.asarray(jax.lax.top_k(-jnp.asarray(d), 10)[1])[0]
        sql = f"SELECT id FROM t ORDER BY cosine_distance(emb, {_lit(v)}) " \
              "LIMIT 10"
        assert _ids(t.sql(sql).rows()) == want.tolist(), sql


def _prepared(ctx, fn, table):
    return ctx.prepare(f"SELECT id, {fn}(emb, ?) AS d FROM {table} "
                       f"ORDER BY {fn}(emb, ?) LIMIT 10")


@pytest.mark.parametrize("fn,table", CASES)
def test_execute_batch_exact_ids_equal_jax(ctxs, fn, table, path):
    j, t, tables = ctxs
    sets = [(v, v) for v in tables[table][1]]
    got = _prepared(t, fn, table).execute_batch(sets, exact=True)
    want = _prepared(j, fn, table).execute_batch(sets, exact=True)
    assert [_ids(g.rows()) for g in got] == [_ids(w.rows()) for w in want]


@pytest.mark.parametrize("fn,table", CASES)
def test_execute_batch_block_exact_ids_equal_jax(ctxs, fn, table, path):
    """300 queries: two chunks of the port's scan."""
    j, t, tables = ctxs
    sets = [(v, v) for v in np.resize(tables[table][1], (300, D))]
    got = _prepared(t, fn, table).execute_batch_block(sets, exact=True)
    want = _prepared(j, fn, table).execute_batch_block(sets, exact=True)
    assert [r[:2] for r in got.rows()] == [r[:2] for r in want.rows()]


@pytest.mark.parametrize("fn,table", CASES)
def test_filtered_batch_ids_equal_jax(ctxs, fn, table, path):
    """A per-query ``price < ?`` mask; a bound of 1 leaves fewer than 10
    rows for some queries, whose +inf distances tie too."""
    j, t, tables = ctxs
    sql = (f"SELECT id, {fn}(emb, ?) AS d FROM {table} WHERE price < ? "
           f"ORDER BY {fn}(emb, ?) LIMIT 10")
    bounds = [1, 50, 90, 100]
    sets = [(v, bounds[i % 4], v) for i, v in enumerate(tables[table][1])]
    got = t.prepare(sql).execute_batch(sets, exact=True)
    want = j.prepare(sql).execute_batch(sets, exact=True)
    assert [_ids(g.rows()) for g in got] == [_ids(w.rows()) for w in want]


def _np_ids(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("metric,table", [("l2", "t"), ("cosine", "c")])
def test_ops_topk_ids_equal_jax(metric, table, path):
    tables, _ = _data()
    x, q = tables[table]
    if metric == "cosine":
        q = q[1:]                   # the functions take no zero query
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1).astype(np.float32)
    _, wi = jtopk.topk_smallest(jnp.asarray(d), 10)
    _, gi = ttopk.topk_smallest(torch.from_numpy(d), 10)
    np.testing.assert_array_equal(_np_ids(gi), _np_ids(wi))
    for chunk_rows in (1024, 1000, 8192):   # scan, scan + tail, one pass
        _, wi = jtopk.chunked_topk_smallest(qj, xj, 10, metric,
                                            chunk_rows=chunk_rows)
        _, gi = ttopk.chunked_topk_smallest(qt, xt, 10, metric,
                                            chunk_rows=chunk_rows)
        np.testing.assert_array_equal(_np_ids(gi), _np_ids(wi))
    _, wi = jtopk.brute_force_topk(qj, xj, 10, metric, chunk_rows=1000)
    _, gi = ttopk.brute_force_topk(qt, xt, 10, metric, chunk_rows=1000)
    np.testing.assert_array_equal(_np_ids(gi), _np_ids(wi))


@pytest.mark.parametrize("k", [1, 10, 64])
def test_smallest_lowest_index_equals_lax_top_k(k, path):
    """Both ways of selecting equal ``lax.top_k(-d)``: the sort, and the
    top-(k+1) (rows without a tie at the k-th place are only reordered,
    rows with one take the second selection), signed zeros and +inf
    included."""
    import jax

    rng = np.random.default_rng(k)
    d = rng.integers(0, 6, (64, 300)).astype(np.float32)
    d[::4] = rng.permutation(300 * 16).reshape(16, 300)   # no ties
    d[1, :40] = -0.0
    d[1, 40:80] = 0.0
    d[2, 5:] = np.inf
    d[3] = np.repeat(np.arange(150), 2)[rng.permutation(300)]  # ties within
    wv, wi = jax.lax.top_k(-jnp.asarray(d), k)
    gv, gi = ttopk.topk_smallest_lowest_index(torch.from_numpy(d), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gv.numpy().tobytes() == (-np.asarray(wv)).tobytes()


def test_blocks_select_each_block_as_lax_top_k(path):
    """A stream of blocks, tied and untied, each as ``lax.top_k(-d)``: a
    block's tied rows are selected again one block later."""
    import jax

    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 5, (9, 400)).astype(np.float32),
              rng.permutation(4000).reshape(10, 400).astype(np.float32),
              rng.integers(0, 3, (7, 400)).astype(np.float32)]
    gv, gi = ttopk.topk_smallest_lowest_index_blocks(
        (torch.from_numpy(b) for b in blocks), 10)
    want = [jax.lax.top_k(-jnp.asarray(b), 10) for b in blocks]
    np.testing.assert_array_equal(
        gi.numpy(), np.concatenate([np.asarray(wi) for _, wi in want]))
    assert gv.numpy().tobytes() == np.concatenate(
        [-np.asarray(wv) for wv, _ in want]).tobytes()
