"""A prepared KNN batch's parameter sets taken into the query matrix in bulk.

``PreparedStatement._as_query_matrix`` and ``_split_param_sets`` take a
regular batch in a few numpy calls and hand any other batch to the per-set
loop they kept (``_query_matrix_loop``, ``_split_param_sets_loop``). For
every input form: the port's answer equals its loop's (the same f32,
C-contiguous matrix bit for bit, the same None or the same exception) and
the JAX package's, and ``knn_params_bulk`` or ``knn_params_loop`` counts the
batch. Then whole batches of copies through ``execute_batch_block`` in both
packages, and the refusals that reach the caller. Torch on the CPU, asked
for by name; a small table of the same rows in each package.
"""

import numpy as np
import pytest

import databend_tpu.expression as jexpr
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.errors import BadArguments
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing
from databend_tpu_torch.utils.metrics import METRICS

N, D, B = 700, 8, 6
KNN = ("SELECT id, l2_distance(emb, ?) AS d FROM t "
       "ORDER BY l2_distance(emb, ?) LIMIT 5")
KNN1 = "SELECT id FROM t ORDER BY l2_distance(emb, ?) LIMIT 5"
FILTERED = ("SELECT id, l2_distance(emb, ?) AS d FROM t WHERE g < ? "
            "ORDER BY l2_distance(emb, ?) LIMIT 5")


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _load(ctx, expr_mod, types_mod, x):
    ctx.sql(f"CREATE TABLE t (id BIGINT, g BIGINT, emb VECTOR({D})) "
            f"ROW_PER_BLOCK='256'")
    ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2'")
    ids = np.arange(len(x), dtype=np.int64)
    ctx.insert_block("t", expr_mod.DataBlock(
        ["id", "g", "emb"],
        [expr_mod.Column.from_numpy(ids),
         expr_mod.Column.from_numpy(ids % 10),
         expr_mod.Column.from_numpy(x, types_mod.VectorType(D))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] \
        + 0.1 * rng.standard_normal((B, D)).astype(np.float32)
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    _load(j, jexpr, jtypes, x)
    _load(t, texpr, ttypes, x)
    yield j, t, q
    j.close()
    t.close()


def _nan(q):
    w = q.copy()
    w[1, 3] = np.nan
    return w


def _one_off(q):
    w = q.copy()
    w[2, 5] += 1.0
    return w


# (statement, the batch made from the queries q [B, D] f32, the way the
# port takes it in); each loop answer is its own: a matrix, None or raising.
FORMS = {
    "benchmark": (KNN, lambda q: [(v,) * 2 for v in q], "bulk"),
    "equal_copies": (KNN, lambda q: [(v, v.copy()) for v in q], "bulk"),
    "f64_beside_f32": (KNN, lambda q: [(v.astype(np.float64), v)
                                       for v in q], "bulk"),
    "python_lists": (KNN, lambda q: [(v.tolist(), v.tolist()) for v in q],
                     "bulk"),
    "list_sets": (KNN, lambda q: [[v, v] for v in q], "bulk"),
    "one_element_differs": (KNN, lambda q: list(zip(q, _one_off(q))),
                            "loop"),
    "nan_vector": (KNN, lambda q: [(v, v) for v in _nan(q)], "loop"),
    "nan_vector_copies": (KNN, lambda q: list(zip(_nan(q), _nan(q))),
                          "loop"),
    "ragged": (KNN, lambda q: [(v, v) for v in q[:-1]]
               + [(q[-1, :-1], q[-1, :-1])], "loop"),
    "wrong_length": (KNN, lambda q: [(v, v) for v in q[:-1]] + [(q[-1],)],
                     "loop"),
    "ndarray_for_tuple": (KNN, lambda q: [(v, v) for v in q[:-1]]
                          + [np.stack([q[-1], q[-1]])], "loop"),
    "mixed_tuple_list": (KNN, lambda q: [(v, v) for v in q[:-1]]
                         + [[q[-1], q[-1]]], "loop"),
    "scalars": (KNN, lambda q: [(float(v[0]),) * 2 for v in q], "loop"),
    "strings": (KNN, lambda q: [("a", "a")] * len(q), "loop"),
    "none": (KNN, lambda q: [(None, None)] * len(q), "loop"),
    "empty": (KNN, lambda q: [], "loop"),
    "single_bare_arrays": (KNN1, lambda q: list(q), "bulk"),
    "single_bare_lists": (KNN1, lambda q: [v.tolist() for v in q], "bulk"),
    "single_one_tuples": (KNN1, lambda q: [(v,) for v in q], "bulk"),
    "single_matrix": (KNN1, lambda q: q.astype(np.float64), "bulk"),
    "single_mixed_wrapped_bare": (KNN1, lambda q: [(v,) for v in q[:3]]
                                  + list(q[3:]), "loop"),
    "single_ragged": (KNN1, lambda q: list(q[:-1]) + [q[-1, :-1]], "loop"),
    "single_scalars": (KNN1, lambda q: [float(v[0]) for v in q], "loop"),
    "single_buffer_in_tuple": (KNN1, lambda q: [(memoryview(v),) for v in q],
                               "loop"),
    "single_zero_d_wrapped": (KNN1, lambda q: [[float(v[0])] for v in q[:-1]]
                              + [[np.array(q[-1, 0])]], "loop"),
    "single_empty": (KNN1, lambda q: [], "loop"),
    "filtered": (FILTERED, lambda q: [(v, 7, v) for v in q], "bulk"),
    "filtered_copies": (FILTERED, lambda q: [(v, i, v.copy())
                                             for i, v in enumerate(q)],
                        "bulk"),
    "filtered_bad_operand": (FILTERED, lambda q: [(v, "x", v) for v in q],
                             "bulk"),
    "filtered_differ": (FILTERED, lambda q: [(a, 7, b) for a, b
                                             in zip(q, _one_off(q))],
                        "loop"),
    "filtered_nan": (FILTERED, lambda q: [(v, 7, v) for v in _nan(q)],
                     "loop"),
    "filtered_ragged": (FILTERED, lambda q: [(v, 7, v) for v in q[:-1]]
                        + [(q[-1, :-1], 7, q[-1, :-1])], "loop"),
}


def _outcome(fn, sets):
    """("matrix", dtype, shape, bytes, contiguous), ("none",) or
    ("raises", type name); a filtered answer adds its operand arrays."""
    try:
        got = fn(sets)
    except Exception as e:                          # noqa: BLE001
        return ("raises", type(e).__name__)
    if got is None:
        return ("none",)
    Q, fvals = got if isinstance(got, tuple) else (got, None)
    out = ("matrix", Q.dtype, Q.shape, Q.tobytes(), Q.flags.c_contiguous)
    if fvals is not None:
        out += tuple((f.dtype, f.tobytes()) for f in fvals)
    return out


def _parse(p, filtered):
    return p._split_param_sets if filtered else p._as_query_matrix


@pytest.mark.parametrize("form", list(FORMS))
def test_bulk_matches_loop_and_jax(ctxs, form):
    j, t, q = ctxs
    sql, make, way = FORMS[form]
    filtered = sql == FILTERED
    tp, jp = t.prepare(sql), j.prepare(sql)
    if filtered:                    # the filter operands' kinds
        assert tp._knn.refresh() and jp._knn.refresh()
    sets = make(q)
    before = METRICS.snapshot()
    got = _outcome(_parse(tp, filtered), sets)
    after = METRICS.snapshot()
    counted = {w: after.get(f"knn_params_{w}", 0)
               - before.get(f"knn_params_{w}", 0) for w in ("bulk", "loop")}
    assert counted == {"bulk": int(way == "bulk"),
                       "loop": int(way == "loop")}
    loop = tp._split_param_sets_loop if filtered else tp._query_matrix_loop
    if form != "single_matrix":     # the [B, d] array never reaches a loop
        assert got == _outcome(loop, sets)
    assert got == _outcome(_parse(jp, filtered), sets)
    if got[0] == "matrix":
        assert got[1] == np.float32 and got[4]


def _same_rows(got, want):
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    np.testing.assert_allclose([r[-1] for r in got], [r[-1] for r in want],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sql", [KNN, FILTERED])
def test_batch_block_of_copies_matches_jax(ctxs, sql):
    """Copies of each query, not the same objects, answer as the JAX
    package does; the batch took the bulk path."""
    j, t, q = ctxs
    if sql == KNN:
        sets = [(v, v.copy()) for v in q]
    else:
        sets = [(v, i, v.copy()) for i, v in enumerate(q)]
    before = METRICS.snapshot().get("knn_params_bulk", 0)
    got = t.prepare(sql).execute_batch_block(sets, exact=True).rows()
    assert METRICS.snapshot()["knn_params_bulk"] - before == 1
    _same_rows(got, j.prepare(sql).execute_batch_block(sets,
                                                        exact=True).rows())


@pytest.mark.parametrize("form", ["one_element_differs", "nan_vector",
                                  "filtered_differ", "filtered_nan"])
def test_batch_block_refuses_disagreeing_placeholders(ctxs, form):
    _, t, q = ctxs
    sql, make, _ = FORMS[form]
    with pytest.raises(BadArguments):
        t.prepare(sql).execute_batch_block(make(q), exact=True)
