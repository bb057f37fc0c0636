"""The device scan-aggregate route through both SessionContexts.

The same seeded rows go into a databend_tpu context and a databend_tpu_torch
context (torch on the CPU, asked for by name), each with
``device_scan_agg_min_rows = 0``. Every statement shape of the reference's
route tests (tests/test_device_scan_agg.py) and a TPC-H sf 0.01 lineitem set
(Q1, Q6, and a statement for each of the matmul, sort and COUNT(DISTINCT)
paths) runs routed in both packages: each package's own METRICS must show
its route engaged, and the port's rows must equal the JAX package's and the
port's own host path (integers equal, floats within ``rel=1e-12``: the
limb sums are exact, the host sums f64). On CPU tensors the grouped-sum
wrapper runs its plain version, held here to ``np.add.at``; the limb
arithmetic is held to the JAX functions on negative and large limbs.
"""

import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import databend_tpu.expression as jexpr
import databend_tpu.pipeline.device_scan_agg as jdsa
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing
from databend_tpu.utils.metrics import METRICS as JMETRICS

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.pipeline.device_scan_agg as tdsa
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.ops import grouped_sums as tgs
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing
from databend_tpu_torch.utils.metrics import METRICS as TMETRICS

from benchmarks.tpch import DDL, QUERIES, generate

DEFAULTS = {"enable_device_local_execution": 1,
            "device_scan_agg_min_rows": 0,
            "device_scan_agg_max_groups": 64,
            "device_scan_agg_max_groups_matmul": 65536,
            "device_scan_agg_max_groups_sort": 1 << 22,
            "device_scan_agg_max_pull_mb": 16}


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


def _load_t(ctx, e, ty, name, n, seed=0):
    """The reference tests' table: string, int and date keys, 2-decimal
    doubles (one of them negative), a nullable int."""
    rng = np.random.default_rng(seed)
    ks = rng.choice(["A", "B", "C"], n)
    k2 = rng.integers(0, 2, n)
    d = rng.integers(10000, 12000, n)
    q = rng.integers(1, 51, n).astype(float)
    p = (rng.random(n) * 1000).round(2)
    x = rng.integers(0, 100, n).astype(object)
    x[rng.random(n) < 0.1] = None
    neg = (rng.random(n) * 20 - 10).round(2)
    ctx.sql(f"create table {name} (k string, k2 int, d date, q double,"
            " p double, x int null, neg double)")
    cols = [e.Column.from_pylist(list(ks), ty.String),
            e.Column(ty.Int64, k2.astype(np.int64)),
            e.Column(ty.Date, d.astype(np.int32)),
            e.Column(ty.Float64, q), e.Column(ty.Float64, p),
            e.Column.from_pylist(list(x), ty.Int64.wrap_nullable()),
            e.Column(ty.Float64, neg)]
    ctx.insert_block(name, e.DataBlock(
        ["k", "k2", "d", "q", "p", "x", "neg"], cols, n))


def _load_lineitem(ctx, e, ty, cols):
    """``lineitem`` of benchmarks/tpch.py, typed as its ``load`` types it."""
    ctx.sql(DDL["lineitem"])
    names, arrays = [], []
    for name, vals in cols.items():
        names.append(name)
        if name.endswith("date"):
            arrays.append(e.Column(ty.Date, vals.astype(np.int32)))
        elif vals.dtype.kind == "f":
            arrays.append(e.Column(ty.Float64, vals.astype(np.float64)))
        elif vals.dtype.kind in "iu":
            arrays.append(e.Column(ty.Int64, vals.astype(np.int64)))
        else:
            arrays.append(e.Column.from_pylist([str(v) for v in vals],
                                               ty.String))
    ctx.insert_block("lineitem", e.DataBlock(names, arrays))


@pytest.fixture(scope="module")
def ctxs():
    lineitem = generate(0.01, seed=42)["lineitem"]
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load_t(ctx, e, ty, "t", 5000)
        _load_t(ctx, e, ty, "t3", 3000)      # multi-chunk, CHUNK_ROWS 777
        _load_t(ctx, e, ty, "t4", 4000)      # multi-chunk, CHUNK_ROWS 999
        _load_t(ctx, e, ty, "small", 500)
        _load_t(ctx, e, ty, "snap", 2000)
        ctx.sql("create table e (v double)")
        ctx.insert_block("e", e.DataBlock(
            ["v"], [e.Column(ty.Float64, np.full(20000, 0.1))], 20000))
        ctx.sql("create table g (u bigint, w bigint) row_per_block='100'")
        u = np.sort(np.random.default_rng(0).integers(0, 5, 1000))
        ctx.insert_block("g", e.DataBlock(
            ["u", "w"], [e.Column(ty.Int64, u.astype(np.int64)),
                         e.Column(ty.Int64, np.ones(1000, np.int64))]))
        _load_lineitem(ctx, e, ty, lineitem)
    yield j, t
    j.close()
    t.close()


def _set(ctx, overrides=None):
    for name, value in {**DEFAULTS, **(overrides or {})}.items():
        ctx.sql(f"set {name} = {value}")


def _count(metrics, name):
    return metrics.snapshot().get(name, 0)


def _routed_rows(ctx, metrics, sql):
    """The statement's rows with the route on; the route must have engaged
    once, without an error."""
    before = _count(metrics, "device_scan_agg_queries")
    errors = _count(metrics, "device_scan_agg_errors")
    rows = ctx.sql(sql).rows()
    assert _count(metrics, "device_scan_agg_queries") == before + 1, \
        f"route did not engage for: {sql}"
    assert _count(metrics, "device_scan_agg_errors") == errors
    return rows


def _assert_same(want, got):
    assert len(want) == len(got), (want, got)
    for wr, gr in zip(want, got):
        assert len(wr) == len(gr)
        for a, b in zip(wr, gr):
            if isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, rel=1e-12, abs=1e-9), (wr, gr)
            else:
                assert a == b, (wr, gr)


@pytest.fixture
def engines(monkeypatch):
    """The grouping engine of every program the port's route builds."""
    seen = []
    real = tdsa._build_program

    def spy(ir):
        seen.append(ir[4])
        return real(ir)

    monkeypatch.setattr(tdsa, "_build_program", spy)
    return seen


def _both(ctxs, sql, overrides=None, engine=None, engines=None):
    """JAX routed, port routed, port host: the port's routed rows must
    equal both."""
    j, t = ctxs
    _set(j, overrides)
    _set(t, overrides)
    jax_rows = _routed_rows(j, JMETRICS, sql)
    if engines is not None:
        engines.clear()
    port_rows = _routed_rows(t, TMETRICS, sql)
    if engine is not None:
        assert engines == [engine]
    t.sql("set enable_device_local_execution = 0")
    host_rows = t.sql(sql).rows()
    _assert_same(jax_rows, port_rows)
    _assert_same(host_rows, port_rows)
    return port_rows


FILTERS = ["d > to_date('1999-05-05')", "k = 'A'", "k2 = 1",
           "q >= 10 and q < 40", "x is null", "x is not null",
           "not (k = 'B')", "k = 'A' or k2 = 0",
           "p <= 500.25 and neg > -5"]

# (id, settings, engine, statement): tests/test_device_scan_agg.py's shapes
CASES = [
    ("all_agg_kinds", {}, "mask", """
        select k, k2, sum(q) s1, sum(p) s2, sum(p*(1-q/100)) s3,
               avg(p) a1, count(*) c, count(x) cx, sum(x) sx,
               min(p) mp, max(d) md, min(k) mk, sum(neg) sn
        from t where d <= to_date('2002-09-02') and k <> 'C'
        group by k, k2 order by k, k2"""),
    *[(f"filter{i}", {}, "mask",
       f"select k, count(*), sum(p) from t where {cond}"
       " group by k order by k") for i, cond in enumerate(FILTERS)],
    ("global", {}, "mask", "select sum(p), avg(q), count(*), count(x),"
                           " min(d), max(p) from t where k <> 'Z'"),
    ("empty_filter", {}, "mask", "select sum(p), count(*), min(d) from t"
                                 " where d < to_date('1970-01-02')"),
    ("negative_bias", {}, "mask", "select k, sum(neg), min(neg), max(neg)"
                                  " from t group by k order by k"),
    ("sort_engine", {"device_scan_agg_max_groups": 2,
                     "device_scan_agg_max_groups_matmul": 2}, "sort", """
        select k, k2, d, count(*), sum(p), min(p), max(d), sum(x),
               count(x), avg(neg)
        from t where q < 45 group by k, k2, d order by k, k2, d"""),
    ("distinct_grouped", {}, "mask", """
        select k, count(distinct k2), count(distinct x), count(*)
        from t group by k order by k"""),
    ("distinct_global", {}, "mask", "select count(distinct q),"
     " count(distinct x) from t where k <> 'B'"),
    ("like", {}, "mask", """
        select k, count(*), sum(p) from t
        where k like 'A%' or k like '%C' group by k order by k"""),
    ("not_like", {}, "mask",
     "select count(*), sum(q) from t where k not like 'B%'"),
    ("expr_key_upper", {}, "mask", """
        select upper(k) as u, count(*), sum(p) from t
        group by u order by u"""),
    ("expr_key_concat", {}, "mask", """
        select concat(k, '_') as u, count(*) from t
        where q < 30 group by u order by u"""),
    ("matmul_engine", {"device_scan_agg_max_groups": 4}, "matmul", """
        select k, k2, d, count(*), sum(p), sum(x), count(x), avg(neg)
        from t where q < 45 group by k, k2, d order by k, k2, d"""),
    ("matmul_negative_null", {"device_scan_agg_max_groups": 1}, "matmul", """
        select d, sum(neg), sum(x), count(*) from t
        group by d order by d"""),
    ("computed_lut_planes", {}, "mask", """
        select k, avg(length(k)), sum(length(k) + 2), count(*)
        from t where q < 40 group by k order by k"""),
    ("computed_nullable_lut", {}, "mask", """
        select k, sum(x * 2 + 1), count(x), avg(x) from t
        group by k order by k"""),
    ("computed_matmul", {"device_scan_agg_max_groups": 1}, "matmul", """
        select d, avg(length(k)), sum(x), count(*) from t
        group by d order by d"""),
    ("merged_entries", {}, "mask", """
        select k, upper(k) as u, concat(k, '!') as c2, count(*), sum(p)
        from t group by k, u, c2 order by k"""),
    ("merged_entries_filtered", {}, "mask", """
        select upper(k) as u, length(k) as lk, count(x)
        from t where q < 30 group by u, lk order by u, lk"""),
    ("restricted_in", {"device_scan_agg_max_groups": 2,
                       "device_scan_agg_max_groups_matmul": 2,
                       "device_scan_agg_max_groups_sort": 100}, "sort", """
        select q, count(*), sum(p) from t
        where q in (3, 7, 11) group by q order by q"""),
    ("restricted_range", {"device_scan_agg_max_groups": 2,
                          "device_scan_agg_max_groups_matmul": 2,
                          "device_scan_agg_max_groups_sort": 6000}, "sort",
     """
        select q, d, count(*) from t
        where q = 5 and d < to_date('2001-01-01')
        group by q, d order by q, d"""),
]

# the TPC-H statements of chip_smoke.py's [agg] phase, at sf 0.01 (the sort
# statement's grid, 2,001 parts, is forced past the matmul cap)
TPCH = [
    ("q1", {}, "mask", QUERIES["q1"]),
    ("q6", {}, "mask", QUERIES["q6"]),
    ("by_supplier", {}, "matmul",
     "select l_suppkey, sum(l_extendedprice), sum(l_quantity), count(*)"
     " from lineitem group by l_suppkey order by l_suppkey"),
    ("by_part", {"device_scan_agg_max_groups_matmul": 1000}, "sort",
     "select l_partkey, sum(l_quantity), count(*) from lineitem"
     " group by l_partkey order by l_partkey"),
    ("distinct_suppliers", {}, "mask",
     "select l_returnflag, count(distinct l_suppkey) from lineitem"
     " group by l_returnflag order by l_returnflag"),
]


@pytest.mark.parametrize("overrides,engine,sql",
                         [c[1:] for c in CASES + TPCH],
                         ids=[c[0] for c in CASES + TPCH])
def test_routed_rows_equal_jax(ctxs, engines, overrides, engine, sql):
    _both(ctxs, sql, overrides, engine, engines)


def test_tpch_q1_q6_sums_exact(ctxs):
    """Q1's and Q6's sums equal a numpy computation in integer cents."""
    li = generate(0.01, seed=42)["lineitem"]
    _, t = ctxs
    _set(t)
    cents = np.rint(li["l_extendedprice"] * 100).astype(np.int64)
    disc = np.rint(li["l_discount"] * 100).astype(np.int64)
    tax = np.rint(li["l_tax"] * 100).astype(np.int64)
    ship = li["l_shipdate"]
    got = _routed_rows(t, TMETRICS, QUERIES["q1"])
    keep = ship <= 10471            # 1998-09-02
    for row in got:
        m = keep & (li["l_returnflag"] == row[0]) \
            & (li["l_linestatus"] == row[1])
        charge = int((cents[m] * (100 - disc[m]) * (100 + tax[m])).sum())
        assert row[5] == charge / 10 ** 6
        assert row[9] == int(m.sum())
    (q6,), = _routed_rows(t, TMETRICS, QUERIES["q6"])
    m = (ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7) \
        & (li["l_quantity"] < 24)
    assert q6 == int((cents[m] * disc[m]).sum()) / 10 ** 4


@pytest.mark.parametrize("chunk,table,overrides,sql", [
    (777, "t3", {}, """
        select k, sum(p), count(*), min(p), max(d), sum(x)
        from t3 where q < 40 group by k order by k"""),
    (999, "t4", {"device_scan_agg_max_groups": 2}, """
        select k, d, count(distinct x), count(*), sum(p)
        from t4 group by k, d order by k, d"""),
], ids=["sums_chunk777", "distinct_chunk999"])
def test_multi_chunk(ctxs, monkeypatch, chunk, table, overrides, sql):
    """Row chunks combine on the host (and the distinct pair concatenates
    them on the device) in both packages."""
    monkeypatch.setattr(jdsa, "CHUNK_ROWS", chunk)
    monkeypatch.setattr(tdsa, "CHUNK_ROWS", chunk)
    _both(ctxs, sql, overrides)


def test_bails_to_host(ctxs):
    """Ineligible shapes decline in both packages, and no error counts."""
    stmts = [({"device_scan_agg_max_groups_matmul": 64,
               "device_scan_agg_max_groups_sort": 64},
              "select q, p, count(*) from t group by q, p limit 3"),
             ({"device_scan_agg_max_groups_matmul": 1000000,
               "device_scan_agg_max_groups": 2,
               "device_scan_agg_max_groups_sort": 2},
              "select k, min(p), count(*) from t group by k"),
             ({}, "select k, count(distinct q + 1) from t group by k")]
    for ctx, metrics in zip(ctxs, (JMETRICS, TMETRICS)):
        before = _count(metrics, "device_scan_agg_queries")
        errors = _count(metrics, "device_scan_agg_errors")
        for overrides, sql in stmts:
            _set(ctx, overrides)
            ctx.sql(sql).rows()
        assert _count(metrics, "device_scan_agg_queries") == before
        assert _count(metrics, "device_scan_agg_errors") == errors


def test_route_respects_min_rows(ctxs):
    for ctx, metrics in zip(ctxs, (JMETRICS, TMETRICS)):
        _set(ctx, {"device_scan_agg_min_rows": 1000000})
        before = _count(metrics, "device_scan_agg_queries")
        ctx.sql("select k, count(*) from small group by k").rows()
        assert _count(metrics, "device_scan_agg_queries") == before


def test_exactness_beats_host_f64(ctxs):
    """The limb sum of 20,000 x 0.1 is exactly 2000 in both packages."""
    for ctx, metrics in zip(ctxs, (JMETRICS, TMETRICS)):
        _set(ctx)
        assert _routed_rows(ctx, metrics, "select sum(v) from e") \
            == [(2000.0,)]


def test_snapshot_isolation(ctxs):
    """A new snapshot gets new resident forms in both packages."""
    for ctx in ctxs:
        _set(ctx)
        r1 = ctx.sql("select count(*) from snap where q < 100").rows()
        ctx.sql("insert into snap select * from snap")
        r2 = ctx.sql("select count(*) from snap where q < 100").rows()
        assert r2[0][0] == 2 * r1[0][0]


def test_topn_above_aggregate(ctxs):
    """ORDER BY ... LIMIT over a routed aggregate: the reference fuses it
    on the device, the port finishes it on the host (finalize fusion is
    not ported); the rows are the same, route on or off."""
    u = np.sort(np.random.default_rng(0).integers(0, 5, 1000))
    counts = sorted(zip(*np.unique(u, return_counts=True)))
    want = [(int(a), int(b)) for a, b in counts]
    for ctx in ctxs:
        for dev in (0, 1):
            _set(ctx, {"enable_device_local_execution": dev})
            got = ctx.sql("select u, count(*) from g group by u"
                          " order by u limit 2").rows()
            assert [tuple(x) for x in got] == want[:2], (dev, got)
            got = ctx.sql("select u, count(*) from g group by u"
                          " limit 10").rows()
            assert sorted(got) == want, (dev, got)


def test_kernel_failure_raises(ctxs, monkeypatch):
    """A grouped-sum wrapper that fails makes the statement fail: the route
    never answers from the host behind a broken kernel."""
    def broken(gid, rows, groups):
        raise RuntimeError("grouped_sums launch failed: injected")

    monkeypatch.setattr(tgs, "grouped_sums", broken)
    _, t = ctxs
    _set(t)
    errors = _count(TMETRICS, "device_scan_agg_errors")
    with pytest.raises(RuntimeError, match="injected"):
        t.sql("select k, count(*), sum(p) from t group by k").rows()
    assert _count(TMETRICS, "device_scan_agg_errors") == errors


@pytest.mark.parametrize("name", ["q1", "by_supplier", "matmul_engine",
                                  "all_agg_kinds"])
def test_program_sums_passes_row_list(ctxs, monkeypatch, name):
    """The route hands grouped_sums its value rows as a list of [n] tensors,
    read where they lie: it never stacks them into a [K, n] block."""
    overrides, _, sql = {c[0]: c[1:] for c in CASES + TPCH}[name]
    passed, stacked = [], []
    real_stack = torch.stack

    def stack_spy(tensors, *args, **kwargs):
        stacked.append(tensors)
        return real_stack(tensors, *args, **kwargs)

    def sums_spy(gid, rows, groups):
        passed.append(rows)
        return tgs.grouped_sums(gid, rows, groups)

    monkeypatch.setattr(tdsa, "gsums",
                        types.SimpleNamespace(grouped_sums=sums_spy))
    monkeypatch.setattr(torch, "stack", stack_spy)
    _, t = ctxs
    _set(t, overrides)
    _routed_rows(t, TMETRICS, sql)
    assert passed
    for rows in passed:
        assert isinstance(rows, list) and rows
        assert all(r.ndim == 1 and r.dtype == torch.int32 for r in rows)
        assert not any(s is rows for s in stacked)


def test_grid_past_the_cluster_reach(ctxs, monkeypatch):
    """The group caps are settings (the matmul engine's up to 2^24 groups):
    raised, a GROUP BY of 1,002,001 groups, one row wider than two blocks'
    shared memory, runs through grouped_sums like any other and equals the
    host route. The kernel's plan places such a grid in out (global
    atomics): it has a placement for every grid the route gives it."""
    _, t = ctxs
    n = 2000
    i = np.arange(n, dtype=np.int64)
    a, b = i % 1000, (7 * i + i // 1000) % 1000
    v = np.random.default_rng(3).integers(-10 ** 6, 10 ** 6, n)
    t.sql("create table wide (a bigint, b bigint, v bigint)")
    t.insert_block("wide", texpr.DataBlock(
        ["a", "b", "v"], [texpr.Column(ttypes.Int64, x) for x in (a, b, v)]))
    shapes = []

    def sums_spy(gid, rows, groups):
        shapes.append((gid.shape[0], len(rows), groups))
        return tgs.grouped_sums(gid, rows, groups)

    monkeypatch.setattr(tdsa, "gsums",
                        types.SimpleNamespace(grouped_sums=sums_spy))
    sql = ("select a, b, count(*), sum(v) from wide group by a, b"
           " order by a, b")
    _set(t, {"device_scan_agg_max_groups_matmul": 1 << 24,
             "device_scan_agg_max_pull_mb": 0})
    routed = _routed_rows(t, TMETRICS, sql)
    t.sql("set enable_device_local_execution = 0")
    _assert_same(t.sql(sql).rows(), routed)
    assert len(routed) == n
    assert shapes and all(g == 1001 * 1001 for _, _, g in shapes)
    for rows_n, k, groups in shapes:
        assert all(launch.placement == "global"
                   for launch in tgs._plan(rows_n, k, groups, 132))


def _limbs_pair(rng, n, n_limbs, bound):
    vals = rng.integers(-bound, bound + 1, (n_limbs, n)).astype(np.int32)
    maxabs = [bound] * n_limbs
    return (jdsa._Limbs([jnp.asarray(v) for v in vals], list(maxabs)),
            tdsa._Limbs([torch.from_numpy(v.copy()) for v in vals],
                        list(maxabs)))


def _value(limbs):
    return sum(np.asarray(l, np.int64) * 256 ** i
               for i, l in enumerate(limbs.limbs))


@pytest.mark.parametrize("op", ["renorm", "add", "sub", "mul"])
def test_limb_arithmetic_equals_jax(op):
    """Negative and large int32 limbs: the port's carries (floor division)
    give the JAX package's limbs, bounds and value."""
    rng = np.random.default_rng(5)
    ja, ta = _limbs_pair(rng, 1000, 3, 1 << 20)
    jb, tb = _limbs_pair(rng, 1000, 2, 300)
    if op == "renorm":
        jr, tr = (jdsa._limb_renorm(ja, jdsa.LIMB_MAX),
                  tdsa._limb_renorm(ta, tdsa.LIMB_MAX))
        want = _value(ja)
    elif op in ("add", "sub"):
        jr, tr = (jdsa._limb_add(ja, jb, sub=op == "sub"),
                  tdsa._limb_add(ta, tb, sub=op == "sub"))
        want = _value(ja) + (-1 if op == "sub" else 1) * _value(jb)
    else:
        jr, tr = jdsa._limb_mul(ja, jb), tdsa._limb_mul(ta, tb)
        want = _value(ja) * _value(jb)
    assert tr.maxabs == jr.maxabs
    assert len(tr.limbs) == len(jr.limbs)
    for jl, tl in zip(jr.limbs, tr.limbs):
        assert tl.dtype == torch.int32
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert all(int(np.abs(tl.numpy()).max()) <= m
               for tl, m in zip(tr.limbs, tr.maxabs))
    np.testing.assert_array_equal(_value(tr), want)


@pytest.mark.parametrize("n,k,groups", [(1000, 3, 1), (5000, 7, 12),
                                        (3000, 4, 500), (1, 1, 0)])
def test_grouped_sums_plain_equals_add_at(n, k, groups):
    rng = np.random.default_rng(n + k)
    gid = rng.integers(0, groups + 1, n).astype(np.int32)
    rows = rng.integers(-255, 256, (k, n)).astype(np.int32)
    want = np.zeros((k, groups + 1), np.int64)
    for r in range(k):
        np.add.at(want[r], gid, rows[r])
    got = tgs.grouped_sums(torch.from_numpy(gid), torch.from_numpy(rows),
                           groups)
    assert got.dtype == torch.int32 and got.shape == (k, groups + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_grouped_sums_checks_inputs():
    gid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tgs.grouped_sums(gid, torch.zeros((2, 4), dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        tgs.grouped_sums(gid, torch.zeros((2, 5), dtype=torch.int32), 1)
