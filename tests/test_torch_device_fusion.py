"""The device finalize fusion (HAVING / ORDER BY ... LIMIT on the [K, G]
grid) through both SessionContexts, and its device functions against the
JAX package's.

The same seeded rows go into a databend_tpu context and a databend_tpu_torch
context (torch on the CPU, asked for by name), each with
``device_scan_agg_min_rows = 0``. Every statement of the reference's
tests/test_device_fusion.py runs routed in both packages: each package's
route must engage (its METRICS count rises and its ``run_fusion`` runs), and
the port's rows must equal the JAX package's and the port's own host route
(integers equal, floats within ``rel=1e-12``: the limb sums are exact, the
host sums f64). The carry normalisation, the word compare, the HAVING mask
and the slot order of the top-k sort are held bit-equal to the JAX
functions on seeded grids with negative and large limbs and thousands of
equal sums.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import databend_tpu.expression as jexpr
import databend_tpu.pipeline.device_fusion as jdf
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing
from databend_tpu.utils.metrics import METRICS as JMETRICS

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.pipeline.device_fusion as tdf
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing
from databend_tpu_torch.utils.metrics import METRICS as TMETRICS


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


def _mkdata(ctx, e, ty, name, n=20000, seed=7, groups=500):
    """The reference tests' table: string and int keys, 2-decimal doubles
    (negatives too), a nullable int."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n)
    k = np.array([f"g{int(v):04d}" for v in g])
    q = rng.integers(1, 51, n).astype(float)
    p = (rng.random(n) * 1000 - 300).round(2)
    x = rng.integers(0, 100, n).astype(object)
    x[rng.random(n) < 0.1] = None
    ctx.sql(f"create table {name} (k string, gi int, q double, p double,"
            " x int null)")
    cols = [e.Column.from_pylist(list(k), ty.String),
            e.Column(ty.Int64, g.astype(np.int64)),
            e.Column(ty.Float64, q), e.Column(ty.Float64, p),
            e.Column.from_pylist(list(x), ty.Int64.wrap_nullable())]
    ctx.insert_block(name, e.DataBlock(["k", "gi", "q", "p", "x"], cols, n))


@pytest.fixture(scope="module")
def ctxs():
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        for groups in (500, 20, 40, 60):
            _mkdata(ctx, e, ty, f"t{groups}", groups=groups)
        ctx.sql("create table d (dgi int, region string)")
        gi = np.arange(60, dtype=np.int64)
        ctx.insert_block("d", e.DataBlock(
            ["dgi", "region"],
            [e.Column(ty.Int64, gi),
             e.Column.from_pylist([f"r{int(v) % 5}" for v in gi],
                                  ty.String)], 60))
        ctx.sql("set device_scan_agg_min_rows = 0")
    yield j, t
    j.close()
    t.close()


def _routed(metrics):
    s = metrics.snapshot()
    return (s.get("device_scan_agg_queries", 0)
            + s.get("device_join_agg_queries", 0))


def _errors(metrics):
    s = metrics.snapshot()
    return (s.get("device_scan_agg_errors", 0)
            + s.get("device_join_agg_errors", 0))


def _fused_rows(ctx, metrics, module, monkeypatch, sql):
    """The statement's rows with the route on; the route must have engaged
    through the package's ``run_fusion``, without an error."""
    calls = []
    real = module.run_fusion
    monkeypatch.setattr(module, "run_fusion",
                        lambda *a: calls.append(1) or real(*a))
    ctx.sql("set enable_device_local_execution = 1")
    before, errors = _routed(metrics), _errors(metrics)
    rows = ctx.sql(sql).rows()
    assert _routed(metrics) > before, f"route did not engage for: {sql}"
    assert calls, f"fusion did not run for: {sql}"
    assert _errors(metrics) == errors
    return rows


def _assert_same(want, got, ordered=True):
    if not ordered:
        want = sorted(want, key=repr)
        got = sorted(got, key=repr)
    assert len(want) == len(got), (len(want), len(got))
    for wr, gr in zip(want, got):
        assert len(wr) == len(gr)
        for a, b in zip(wr, gr):
            if isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, rel=1e-12, abs=1e-9), (wr, gr)
            else:
                assert a == b, (wr, gr)


# (id, statement, ordered): tests/test_device_fusion.py's statements; the
# table's suffix is the reference's ``groups``
CASES = [
    ("topn_sum_desc", """
        select k, sum(p) s from t500 group by k order by s desc limit 10
    """, True),
    ("topn_sum_asc_with_ties_broken_by_key", """
        select k, sum(q) s, count(*) c from t500
        group by k order by c asc, k asc limit 15
    """, True),
    ("topn_order_by_group_key", """
        select k, sum(p) s from t500 group by k order by k desc limit 7
    """, True),
    ("having_only", """
        select k, sum(q) s from t500 group by k having sum(q) > 1050
    """, False),
    ("having_plus_topn", """
        select k, sum(p) s, count(*) c from t500 group by k
        having count(*) >= 30 and sum(q) < 1200
        order by s desc limit 5
    """, True),
    ("having_float_threshold_exact", """
        select k, sum(p) s from t500 group by k having sum(p) >= 10289.25
        order by k limit 100
    """, True),
    ("having_empty_result", """
        select k, sum(q) s from t500 group by k having sum(q) > 1e12
    """, True),
    ("topn_nullable_sum", """
        select gi, sum(x) sx from t500 group by gi
        order by sx desc limit 12
    """, True),
    ("limit_larger_than_groups", """
        select k, count(*) c from t20 group by k order by c desc, k limit 999
    """, True),
    ("multi_key_group_fused", """
        select k, gi % 4 m, sum(p) s from t40 group by k, m
        order by s desc limit 9
    """, True),
    ("fused_join_enrichment_topn", """
        select region, sum(p) s from t60 join d on t60.gi = d.dgi
        group by region order by s desc limit 3
    """, True),
]


@pytest.mark.parametrize("sql,ordered", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_fused_rows_equal_jax(ctxs, monkeypatch, sql, ordered):
    j, t = ctxs
    jax_rows = _fused_rows(j, JMETRICS, jdf, monkeypatch, sql)
    port_rows = _fused_rows(t, TMETRICS, tdf, monkeypatch, sql)
    t.sql("set enable_device_local_execution = 0")
    host_rows = t.sql(sql).rows()
    _assert_same(jax_rows, port_rows, ordered)
    _assert_same(host_rows, port_rows, ordered)
    if "1e12" in sql:
        assert port_rows == []


def test_fused_pull_screen_skipped(ctxs, monkeypatch):
    """A fused top-n takes only [K, k] off the card, so the grid's pull
    screen does not apply: under a pull cap of 1 MB a GROUP BY of 150,001
    groups (a [2, G] grid of 1.2 MB) declines unfused and routes fused."""
    _, t = ctxs
    n = 150_000
    t.sql("create table wide (a bigint, v bigint)")
    t.insert_block("wide", texpr.DataBlock(
        ["a", "v"], [texpr.Column(ttypes.Int64, np.arange(n)[::-1].copy()),
                     texpr.Column(ttypes.Int64, np.arange(n) % 7)]))
    t.sql("set device_scan_agg_max_pull_mb = 1")
    try:
        sql = "select a, count(*) c from wide group by a"
        t.sql("set enable_device_local_execution = 1")
        before = _routed(TMETRICS)
        assert len(t.sql(sql).rows()) == n
        assert _routed(TMETRICS) == before
        rows = _fused_rows(t, TMETRICS, tdf, monkeypatch,
                           sql + " order by c desc, a limit 4")
        assert rows == [(0, 1), (1, 1), (2, 1), (3, 1)]
    finally:
        t.sql("set device_scan_agg_max_pull_mb = 16")


# ------------------------------------------------- the device functions


def _jt(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def _same(tt, jj):
    assert tt.dtype in (torch.int32, torch.bool), tt.dtype
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))


@pytest.mark.parametrize("bound", [255, 1 << 16, 1 << 30])
def test_digits_and_lex_cmp_equal_jax(bound):
    """Negative and large int32 limbs: the digits, the top carry and the
    word compare against a constant are the JAX functions'."""
    rng = np.random.default_rng(bound % 97)
    limbs = [rng.integers(-bound, bound + 1, 4000).astype(np.int32)
             for _ in range(4)]
    jl, tl = _jt(limbs)
    jc, jd = jdf._digits(jnp, jl)
    tc, td = tdf._digits(tl)
    _same(tc, jc)
    for a, b in zip(td, jd):
        _same(a, b)
    for T in (0, -1, 12345, -(1 << 33) + 7, 1 << 40):
        words = tdf._const_words(T, 4)
        if words is None:
            continue
        jg, je = jdf._lex_cmp(jnp, [jc] + jd[::-1], words)
        tg, te = tdf._lex_cmp([tc] + td[::-1], words)
        _same(tg, jg)
        _same(te, je)


def _grid(rng, G, tie_values):
    """[K, G] int32 grid: counts (some empty groups), then a sum of three
    limbs (valid count + limbs) and a count row; limbs from a few values so
    that thousands of groups have equal sums."""
    counts = rng.integers(0, 3, G)
    valid = np.where(rng.random(G) < 0.1, 0, counts)
    limbs = [rng.choice(tie_values, G) for _ in range(3)]
    cnt = rng.integers(0, 4, G)
    return np.stack([counts, valid] + limbs + [cnt]).astype(np.int32)


SUM_ROWS = ((2, -1), (3, -1), (4, -1))

HAVINGS = [
    (),
    (("sum_cmp", "ge", 1, SUM_ROWS, tdf._const_words(-3, 3)),),
    (("sum_cmp", "le", 1, SUM_ROWS, tdf._const_words(0, 3)),
     ("cnt_cmp", "ge", 5, 1)),
    (("sum_cmp", "eq", 1, SUM_ROWS, tdf._const_words(257, 3)),),
    (("sum_cmp", "ne", 1, SUM_ROWS, tdf._const_words(-256, 3)),
     ("cnt_cmp", "le", 5, 2), ("true",)),
    (("cnt_cmp", "eq", 5, 3), ("cnt_cmp", "ne", 0, 1)),
    (("false",),),
]


@pytest.mark.parametrize("having", HAVINGS)
def test_ok_mask_equals_jax(having):
    rng = np.random.default_rng(len(having))
    g = _grid(rng, 5000, np.array([-(1 << 20), -300, -1, 0, 1, 255, 1 << 20],
                                  np.int32))
    ir = (5000, 6, (), having)
    want = jdf._ok_mask(jnp, ir, jnp.asarray(g), ())
    got = tdf._ok_mask(ir, torch.from_numpy(g), ())
    _same(got, want)
    want = jdf._build_count(ir, 0)(jnp.asarray(g))
    assert int(tdf._build_count(ir, 0)(torch.from_numpy(g))) == int(want)


ORDERS = [
    (("sum", 1, SUM_ROWS, False, False),),
    (("sum", 1, SUM_ROWS, True, True), ("count", 5, False)),
    (("count", 5, True), ("key", 1, 40, -1, -1, False, False)),
    (("key", 50, 99, 0, 1, True, True), ("sum", 1, SUM_ROWS, False, True)),
]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("having", HAVINGS[:3])
def test_topk_slot_order_bit_equal(order, having):
    """Thousands of groups with equal sums (limbs from three values): the
    whole slot order of the sort, and the gathered mask and rows, equal the
    JAX program's. The key items read a rank LUT of 100 entries (codes 0..99
    of a stride-50 entry) or the codes themselves."""
    rng = np.random.default_rng(len(order) + 10 * len(having))
    G = 5000
    g = _grid(rng, G, np.array([-1, 0, 1], np.int32))
    word = rng.permutation(100).astype(np.int32)
    isnull = rng.random(100) < 0.2
    luts = [word, isnull]
    ir = (G, 6, order, having)
    tdf._check_gathers(ir, luts, g.shape)
    for kpad in (G, 37):
        jtop, jmask, jrows = jdf._build_topk(ir, 2, kpad)(
            jnp.asarray(g), *[jnp.asarray(a) for a in luts])
        ttop, tmask, trows = tdf._build_topk(ir, 2, kpad)(
            torch.from_numpy(g), *[torch.from_numpy(a) for a in luts])
        _same(ttop, jtop)
        _same(tmask, jmask)
        _same(trows, jrows)


@pytest.mark.parametrize("scale", [1, 100, 10 ** 4])
def test_float_having_bounds_keep_what_the_host_keeps(scale):
    """A HAVING over a sum against a float constant keeps exactly the sums T
    whose finalized float64 ``T / scale`` passes the compare, as a host
    filter over the unfused route does; constants include the float64 of a
    sum itself (TPC-H q15's ``= (select max(...))``)."""
    rng = np.random.default_rng(scale)
    consts = [int(t) / scale for t in rng.integers(-10 ** 12, 10 ** 12, 20)]
    consts += [float(c) for c in rng.standard_normal(10) * 1e6]
    consts += [1970199.5219, 10289.25, 0.1, -0.0, 1e17]
    ops = {"gt": float.__gt__, "gte": float.__ge__, "lt": float.__lt__,
           "lte": float.__le__, "eq": float.__eq__, "neq": float.__ne__}
    held = {"ge": int.__ge__, "le": int.__le__, "eq": int.__eq__,
            "ne": int.__ne__}
    for c in consts:
        centre = round(c * scale)
        for op, cmp in ops.items():
            try:
                bounds = tdf._f64_bounds(op, c, scale)
            except tdf._Bail:
                assert op == "neq" and c == 1e17
                continue
            for T in range(centre - 3, centre + 4):
                want = cmp(T / scale, c)
                got = all(o == "true" or (o != "false" and held[o](T, b))
                          for o, b in bounds)
                assert got == want, (c, op, T, bounds)


def test_gathers_are_checked_not_clamped():
    """A key LUT shorter than its entry's codes, or a grid of another shape,
    raises before any gather: torch has no fill mode for an index past the
    end."""
    ir = (5000, 6, (("key", 50, 99, 0, 1, True, True),), ())
    good = [np.zeros(100, np.int32), np.zeros(100, np.bool_)]
    tdf._check_gathers(ir, good, (6, 5000))
    with pytest.raises(ValueError, match="LUT"):
        tdf._check_gathers(ir, [good[0][:99], good[1]], (6, 5000))
    with pytest.raises(ValueError, match="grid"):
        tdf._check_gathers(ir, good, (6, 4999))
    fp = tdf._FusionPlan((5000, 6, (("key", 0, 0, 1, True, True),), ()),
                         [good[0][:50], good[1]], 5000, 3)
    group = [(0, 99, -1, 99), (1, 49, -1, 49)]
    with pytest.raises(ValueError, match="LUT"):
        tdf.run_fusion(fp, torch.zeros((6, 5000), dtype=torch.int32), group)
