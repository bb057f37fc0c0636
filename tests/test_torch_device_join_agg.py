"""The device join-aggregate route (J1: joins as dictionary enrichment, J2:
aggregate pushdown through a 1:N join) through both SessionContexts.

The same seeded rows go into a databend_tpu context and a databend_tpu_torch
context (torch on the CPU, asked for by name), each with
``device_scan_agg_min_rows = 0``. Every statement of the reference's
tests/test_device_join_agg.py, and TPC-H sf 0.01 (benchmarks/tpch.py, seed
42, all eight tables) q2, q3, q10, q11, q13, q15, q16 and q18, run routed in
both packages: the join route and the finalize fusion must engage as often
in the port as in the JAX package, no route error may be counted, and the
port's rows must equal the JAX package's (integers equal, floats within
``rel=1e-12``), the port's own host route, and for TPC-H
``benchmarks.tpch.check`` against the pandas ``expected``. A device error in
a routed statement's device half must reach the caller.
"""

import tempfile

import numpy as np
import pytest

import databend_tpu.expression as jexpr
import databend_tpu.pipeline.device_fusion as jdf
import databend_tpu.types as jtypes
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing
from databend_tpu.utils.metrics import METRICS as JMETRICS

import databend_tpu_torch.expression as texpr
import databend_tpu_torch.pipeline.device_fusion as tdf
import databend_tpu_torch.pipeline.device_join_agg as tdja
import databend_tpu_torch.pipeline.device_scan_agg as tdsa
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing
from databend_tpu_torch.utils.metrics import METRICS as TMETRICS

from benchmarks import tpch

TPCH_SF, TPCH_SEED = 0.01, 42


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


def _mkstar(ctx, e, ty, n_fact=8000, n_dim=300, seed=0):
    """The reference tests' star: fact(fk, fk2 nullable, v, cat) +
    dim(k unique, attr, grp, price) + dim2(k2 unique, region)."""
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, n_dim + 20, n_fact)  # some fks miss the dim
    fk2 = rng.integers(0, 50, n_fact).astype(object)
    fk2[rng.random(n_fact) < 0.1] = None
    v = (rng.random(n_fact) * 100).round(2)
    cat = rng.choice(["x", "y", "z"], n_fact)
    ctx.sql("create table fact (fk bigint, fk2 bigint null,"
            " v double, cat string)")
    ctx.insert_block("fact", e.DataBlock(
        ["fk", "fk2", "v", "cat"],
        [e.Column(ty.Int64, fk.astype(np.int64)),
         e.Column.from_pylist(list(fk2), ty.Int64.wrap_nullable()),
         e.Column(ty.Float64, v),
         e.Column.from_pylist(list(cat), ty.String)]))
    dk = np.arange(n_dim)
    attr = rng.choice(["A", "B", "C", "D"], n_dim)
    grp = rng.integers(0, 7, n_dim)
    price = (rng.random(n_dim) * 10).round(2)
    ctx.sql("create table dim (k bigint, attr string, grp bigint,"
            " price double)")
    ctx.insert_block("dim", e.DataBlock(
        ["k", "attr", "grp", "price"],
        [e.Column(ty.Int64, dk.astype(np.int64)),
         e.Column.from_pylist(list(attr), ty.String),
         e.Column(ty.Int64, grp.astype(np.int64)),
         e.Column(ty.Float64, price)]))
    ctx.sql("create table dim2 (k2 bigint, region string)")
    ctx.insert_block("dim2", e.DataBlock(
        ["k2", "region"],
        [e.Column(ty.Int64, np.arange(50, dtype=np.int64)),
         e.Column.from_pylist([f"r{i % 5}" for i in range(50)],
                              ty.String)]))


def _load_tpch(ctx, e, ty, data):
    """benchmarks/tpch.py's ``load`` (which imports the JAX package), with
    the given package's columns."""
    money = ("c_acctbal", "s_acctbal", "o_totalprice", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "ps_supplycost")
    for tname, cols in data.items():
        ctx.sql(tpch.DDL[tname])
        names, arrays = [], []
        for cname, vals in cols.items():
            names.append(cname)
            arr = np.asarray(vals)
            if cname.endswith("date"):
                arrays.append(e.Column(ty.Date, arr.astype(np.int32)))
            elif cname in money:
                arrays.append(e.Column(ty.Float64, arr.astype(np.float64)))
            elif arr.dtype.kind in "iu":
                arrays.append(e.Column(ty.Int64, arr.astype(np.int64)))
            else:
                arrays.append(e.Column.from_pylist([str(v) for v in vals],
                                                   ty.String))
        ctx.insert_block(tname, e.DataBlock(names, arrays))
        ctx.sql(f"ANALYZE TABLE {tname}")


@pytest.fixture(scope="module")
def star():
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _mkstar(ctx, e, ty)
        ctx.sql("set device_scan_agg_min_rows = 0")
    yield j, t
    j.close()
    t.close()


@pytest.fixture(scope="module")
def tpch_ctxs():
    data = tpch.generate(TPCH_SF, seed=TPCH_SEED)
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load_tpch(ctx, e, ty, data)
        ctx.sql("set device_scan_agg_min_rows = 0")
    yield j, t, tpch.frames(data)
    j.close()
    t.close()


def _counts(metrics):
    s = metrics.snapshot()
    return {name: s.get(name, 0) for name in (
        "device_join_agg_queries", "device_join_agg_errors",
        "device_scan_agg_errors")}


def _routed(ctx, metrics, fusion_module, monkeypatch, sql):
    """(rows, join-route queries, fusion runs) of the statement with the
    route on; no route error may be counted."""
    runs = []
    real = fusion_module.run_fusion
    monkeypatch.setattr(fusion_module, "run_fusion",
                        lambda *a: runs.append(1) or real(*a))
    ctx.sql("set enable_device_local_execution = 1")
    before = _counts(metrics)
    rows = ctx.sql(sql).rows()
    after = _counts(metrics)
    assert after["device_join_agg_errors"] == \
        before["device_join_agg_errors"], sql
    assert after["device_scan_agg_errors"] == \
        before["device_scan_agg_errors"], sql
    monkeypatch.setattr(fusion_module, "run_fusion", real)
    return (rows, after["device_join_agg_queries"]
            - before["device_join_agg_queries"], len(runs))


def _assert_same(want, got):
    assert len(want) == len(got), (len(want), len(got))
    for wr, gr in zip(want, got):
        assert len(wr) == len(gr)
        for a, b in zip(wr, gr):
            if isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, rel=1e-12, abs=1e-9), (wr, gr)
            else:
                assert a == b, (wr, gr)


def _both(ctxs, monkeypatch, sql, jax_rows_equal=True):
    """JAX routed, port routed, port host: the port's rows equal both (the
    JAX package's unless ``jax_rows_equal`` is False), and the two packages
    route the statement the same way. Returns the port's rows and its
    (join-route queries, fusion runs)."""
    j, t = ctxs[:2]
    jax_rows, jq, jf = _routed(j, JMETRICS, jdf, monkeypatch, sql)
    port_rows, tq, tf = _routed(t, TMETRICS, tdf, monkeypatch, sql)
    t.sql("set enable_device_local_execution = 0")
    host_rows = t.sql(sql).rows()
    assert (tq, tf) == (jq, jf), sql
    if jax_rows_equal:
        _assert_same(jax_rows, port_rows)
    _assert_same(host_rows, port_rows)
    return port_rows, (tq, tf)


# (id, statement): tests/test_device_join_agg.py's statements, each answered
# by one join-route query in both packages
STAR = [
    ("inner_join_enrichment", """
        select attr, count(*), sum(v) from fact
        join dim on fk = k group by attr order by attr"""),
    ("left_join_enrichment_nulls", """
        select attr, count(*), count(grp), sum(v) from fact
        left join dim on fk = k group by attr order by attr"""),
    ("join_dim_filter_and_fact_filter", """
        select attr, count(*), sum(v) from fact
        join dim on fk = k
        where grp < 4 and cat <> 'z' and v > 5
        group by attr order by attr"""),
    ("join_agg_over_dim_values", """
        select cat, sum(price), avg(price), min(attr), max(grp), count(*)
        from fact join dim on fk = k group by cat order by cat"""),
    ("join_merged_dim_group_keys", """
        select grp, attr, count(*), sum(v) from fact
        join dim on fk = k where grp < 3
        group by grp, attr order by grp, attr"""),
    ("chained_joins_two_dims", """
        select region, attr, count(*), sum(v) from fact
        join dim on fk = k
        join dim2 on fk2 = k2
        group by region, attr order by region, attr"""),
    ("join_count_distinct", """
        select attr, count(distinct cat), count(distinct fk2)
        from fact join dim on fk = k group by attr order by attr"""),
    ("j2_agg_pushdown_left", """
        select k, count(v) from dim
        left join fact on k = fk group by k order by k"""),
    ("j2_agg_pushdown_residual_and_inner", """
        select k, count(v), sum(v) from dim
        join fact on k = fk and cat <> 'x'
        group by k order by k"""),
]


@pytest.mark.parametrize("sql", [c[1] for c in STAR],
                         ids=[c[0] for c in STAR])
def test_star_rows_equal_jax(star, monkeypatch, sql):
    _, (queries, _) = _both(star, monkeypatch, sql)
    assert queries == 1


def test_join_route_bails_cleanly(star):
    """Ineligible shapes fall back to the host join in both packages with
    no error counted: non-unique dim keys on both sides (no J1), a group key
    that is not the left join key (no J2)."""
    sql = ("select f1.cat, count(*) from fact f1"
           " join fact f2 on f1.fk = f2.fk group by f1.cat order by f1.cat")
    rows = []
    for ctx, metrics in zip(star, (JMETRICS, TMETRICS)):
        ctx.sql("set enable_device_local_execution = 1")
        before = _counts(metrics)
        rows.append(ctx.sql(sql).rows())
        assert _counts(metrics) == before
    assert rows[0] == rows[1]


# TPC-H sf 0.01, statement -> (join-route queries, fusion runs) in the JAX
# package: J1 in q2, q3, q10, q11 (twice), q16 and q18; J2 in q13; the
# finalize fusion in q3, q10, q11, q15 and q18 (twice)
TPCH = {"q2": (1, 0), "q3": (1, 1), "q10": (1, 1), "q11": (2, 1),
        "q13": (1, 0), "q15": (0, 1), "q16": (1, 0), "q18": (1, 2)}
# q15's fused ``total_revenue = (select max(total_revenue) ...)``: the
# reference compares the exact decimal sum with the float64 constant, never
# equal, and drops the row its host route keeps; the port compares the
# float64 the route finalizes the sum to (device_fusion._f64_bounds), as a
# host filter over the unfused route does, and keeps it
REFERENCE_DROPS_ROWS = {"q15"}


@pytest.mark.parametrize("qname", list(TPCH))
def test_tpch_rows_equal_jax(tpch_ctxs, monkeypatch, qname):
    rows, routes = _both(tpch_ctxs, monkeypatch, tpch.QUERIES[qname],
                         jax_rows_equal=qname not in REFERENCE_DROPS_ROWS)
    assert routes == TPCH[qname]
    assert tpch.check(qname, rows, tpch.expected(tpch_ctxs[2], qname))


@pytest.mark.parametrize("where,sql", [
    ("gather", """
        select cat, min(grp) from fact join dim on fk = k
        group by cat order by cat"""),   # J1: a virtual column's gather
    ("engine", STAR[7][1]),          # J2: the device aggregate over R
    ("fusion", STAR[0][1] + " limit 2"),   # J1 with a fused top-n
], ids=["j1_gather", "j2_engine", "j1_fusion"])
def test_device_error_propagates(star, monkeypatch, where, sql):
    """An error in a routed statement's device half reaches the caller: the
    route never answers from the host behind a failing device, and no route
    error is counted (that counter is for host-side planning errors)."""
    def broken(*a, **k):
        raise RuntimeError("device fault: injected")

    if where == "gather":
        monkeypatch.setattr(tdja, "_gather_codes", broken)
    elif where == "engine":
        monkeypatch.setattr(tdsa, "_build_program", lambda ir: broken)
    else:
        monkeypatch.setattr(tdf, "_build_topk", broken)
    _, t = star
    t.sql("set enable_device_local_execution = 1")
    before = _counts(TMETRICS)
    with pytest.raises(RuntimeError, match="injected"):
        t.sql(sql).rows()
    assert _counts(TMETRICS) == before
