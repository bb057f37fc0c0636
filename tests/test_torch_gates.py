"""The port's route gates: the defaults measured on the H100 and their edges.

A route gate is a setting (or a class constant) that sends a statement to a
device route or keeps it on the host. The JAX package's gates were set on a
TPU; the port's come from ``python3 chip_smoke.py --gates`` on the card and
stand in ``PERF.md``'s "Route gates" table. Checked here, on the CPU:

* the port's defaults equal the card defaults that table records, and the
  JAX package's are still the TPU's;
* ``catalog/pushdown.py``'s dataclass defaults equal the port's settings,
  and ``GRAPH_BUILD_MIN_ROWS`` equals the exact-scan gate;
* no help text of the port's settings names v5e, a tunnel or an RTT, and no
  gate's help text names a TPU;
* at each SQL-visible gate, set small through ``SET`` in both packages, the
  statement on the near side of the gate keeps its path and the one at the
  gate's edge takes the other, with rows equal to the JAX package's.
"""

import os
import re
import tempfile

import numpy as np
import pytest

import databend_tpu.catalog.pushdown as jpushdown
import databend_tpu.expression as jexpr
import databend_tpu.index.inverted.reader as jreader
import databend_tpu.settings as jsettings
import databend_tpu.storage.fuse.table as jtable
import databend_tpu.types as jtypes
from databend_tpu.service.prepared import _MatchServer as JaxMatch
from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

import databend_tpu_torch.catalog.pushdown as tpushdown
import databend_tpu_torch.expression as texpr
import databend_tpu_torch.pipeline.device_scan_agg as tdsa
import databend_tpu_torch.settings as tsettings
import databend_tpu_torch.storage.fuse.table as ttable
import databend_tpu_torch.types as ttypes
from databend_tpu_torch import backend
from databend_tpu_torch.service.prepared import _MatchServer as TorchMatch
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing
from databend_tpu_torch.utils.metrics import METRICS as TMETRICS

from benchmarks.tpch import DDL, QUERIES, generate

PERF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "PERF.md")

# the JAX package's defaults, set on a TPU
TPU = {
    "device_scan_agg_min_rows": 300_000,
    "device_scan_agg_max_groups": 64,
    "device_scan_agg_max_groups_matmul": 65_536,
    "device_scan_agg_max_groups_sort": 1 << 22,
    "device_scan_agg_max_pull_mb": 16,
    "vector_host_scan_max_rows": 1 << 16,
    "vector_exact_scan_max_rows": 1 << 20,
    "GRAPH_BUILD_MIN_ROWS": 1 << 20,
    "DEVICE_MIN_DOCS": 20_000,
}
SETTING_GATES = [n for n in TPU if n not in ("GRAPH_BUILD_MIN_ROWS",
                                             "DEVICE_MIN_DOCS")]


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


def _port_default(name):
    if name == "DEVICE_MIN_DOCS":
        return TorchMatch.DEVICE_MIN_DOCS
    if name == "GRAPH_BUILD_MIN_ROWS":
        return ttable.GRAPH_BUILD_MIN_ROWS
    return tsettings.DEFAULT_SETTINGS[name].default


def _jax_default(name):
    if name == "DEVICE_MIN_DOCS":
        return JaxMatch.DEVICE_MIN_DOCS
    if name == "GRAPH_BUILD_MIN_ROWS":
        return jtable.GRAPH_BUILD_MIN_ROWS
    return jsettings.DEFAULT_SETTINGS[name].default


def _perf_gate_table():
    """{name: card default} from the rows of PERF.md's "Route gates" table:
    a row starts with ``| G<n>``, names its gates in backticks in its second
    cell and ends with the card default (its first number, commas
    dropped)."""
    with open(PERF) as f:
        text = f.read()
    start = text.index("Route gates")
    out = {}
    for line in text[start:].splitlines():
        if not re.match(r"^\| G\d", line):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        number = re.search(r"\d[\d,]*", cells[-1])
        for name in re.findall(r"`([A-Za-z_.]+)`", cells[1]):
            if number is not None:
                out[name.split(".")[-1]] = int(number.group().replace(",", ""))
    return out


@pytest.mark.parametrize("name", list(TPU))
def test_port_default_is_perf_tables(name):
    table = _perf_gate_table()
    assert name in table, f"PERF.md's gate table has no row for {name}"
    assert _port_default(name) == table[name]


@pytest.mark.parametrize("name", list(TPU))
def test_jax_default_is_the_tpus(name):
    assert _jax_default(name) == TPU[name]


def test_jax_reader_twin_is_the_tpus():
    assert jreader.DEVICE_MIN_DOCS == TPU["DEVICE_MIN_DOCS"]


def test_reader_twin_is_the_served_gate():
    from databend_tpu_torch.index.inverted import reader
    assert reader.DEVICE_MIN_DOCS == TorchMatch.DEVICE_MIN_DOCS


@pytest.mark.parametrize("name", ["vector_exact_scan_max_rows",
                                  "vector_host_scan_max_rows"])
def test_pushdown_defaults_are_the_settings(name):
    assert getattr(tpushdown.PushDownInfo(), name) \
        == tsettings.DEFAULT_SETTINGS[name].default
    assert getattr(jpushdown.PushDownInfo(), name) == TPU[name]


def test_graph_build_gate_is_the_exact_scan_gate():
    assert ttable.GRAPH_BUILD_MIN_ROWS \
        == tsettings.DEFAULT_SETTINGS["vector_exact_scan_max_rows"].default


def test_help_texts_state_no_tpu_figure():
    named = [n for n, d in tsettings.DEFAULT_SETTINGS.items()
             if re.search(r"v5e|tunnel|\bRTT\b", d.desc, re.I)]
    assert named == []
    tpu = [n for n in SETTING_GATES if re.search(
        r"\bTPU\b|MXU", tsettings.DEFAULT_SETTINGS[n].desc)]
    assert tpu == []


# --------------------------------------------------------------- the edges

def _load_lineitem(ctx, e, ty, cols):
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


GRID_ROWS = 70_000
# key columns: k<G> holds G - 1 values (the route's grid adds a NULL slot)
GRID_G = (40, 41, 65_536, 65_537)
VEC_ROWS, VEC_D = 256, 8


@pytest.fixture(scope="module")
def ctxs():
    lineitem = generate(0.001, seed=42)["lineitem"]
    rng = np.random.default_rng(5)
    keys = {G: (np.arange(GRID_ROWS, dtype=np.int64) % (G - 1))[
        rng.permutation(GRID_ROWS)] for G in GRID_G}
    q = rng.integers(1, 51, GRID_ROWS).astype(np.int64)
    v = rng.integers(0, 10 ** 6, GRID_ROWS).astype(np.int64)
    x = rng.integers(-8, 9, size=(VEC_ROWS, VEC_D)).astype(np.float32)
    j = JaxContext(data_root=tempfile.mkdtemp())
    t = TorchContext(data_root=tempfile.mkdtemp())
    for ctx, e, ty in ((j, jexpr, jtypes), (t, texpr, ttypes)):
        _load_lineitem(ctx, e, ty, lineitem)
        names = [f"k{G}" for G in GRID_G] + ["q", "v"]
        ctx.sql("CREATE TABLE g (" + ", ".join(f"{n} BIGINT" for n in names)
                + ")")
        ctx.insert_block("g", e.DataBlock(
            names, [e.Column(ty.Int64, keys[G]) for G in GRID_G]
            + [e.Column(ty.Int64, q), e.Column(ty.Int64, v)]))
        ctx.sql(f"CREATE TABLE vt (id BIGINT, emb VECTOR({VEC_D})) "
                f"ROW_PER_BLOCK='{VEC_ROWS}'")
        ctx.sql("CREATE VECTOR INDEX vt_v ON vt(emb) distance='l2' m='8' "
                "ef_construct='32' graphs='always'")
        ctx.insert_block("vt", e.DataBlock(
            ["id", "emb"],
            [e.Column.from_numpy(np.arange(VEC_ROWS, dtype=np.int64)),
             e.Column.from_numpy(x, ty.VectorType(VEC_D))]))
    yield j, t, len(lineitem["l_orderkey"])
    j.close()
    t.close()


def _set(ctxs, **kv):
    for ctx in ctxs[:2]:
        for k, v in kv.items():
            ctx.sql(f"SET {k} = {v}")


def _reset(ctxs):
    _set(ctxs, **{k: _jax_default(k) for k in SETTING_GATES},
         enable_device_local_execution=1)


def _assert_same(want, got):
    want, got = sorted(want), sorted(got)
    assert len(want) == len(got)
    for wr, gr in zip(want, got):
        for a, b in zip(wr, gr):
            if isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, rel=1e-12, abs=1e-9), (wr, gr)
            else:
                assert a == b, (wr, gr)


@pytest.fixture
def engines(monkeypatch):
    """The grouping engine of each program the port's route builds."""
    seen = []
    real = tdsa._build_program
    monkeypatch.setattr(tdsa, "_build_program",
                        lambda ir: seen.append(ir[4]) or real(ir))
    return seen


def _port_route(ctxs, sql, engines):
    """The port's rows (equal to the JAX package's) and the engine its
    route took, or None where it stayed on the host (the pull screen
    declines after the program is built)."""
    j, t, _ = ctxs
    engines.clear()
    before = TMETRICS.counters.get("device_scan_agg_queries", 0)
    got = t.sql(sql).rows()
    routed = TMETRICS.counters.get("device_scan_agg_queries", 0) - before
    _assert_same(j.sql(sql).rows(), got)
    assert routed in (0, 1) and (engines or not routed)
    return engines[-1] if routed else None


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_min_rows_edge(ctxs, engines, q):
    """A table of n rows routes with the gate at n, and stays on the host
    with the gate at n + 1 (the table one row under it)."""
    n = ctxs[2]
    try:
        _set(ctxs, device_scan_agg_min_rows=n)
        assert _port_route(ctxs, QUERIES[q], engines) == "mask"
        _set(ctxs, device_scan_agg_min_rows=n + 1)
        assert _port_route(ctxs, QUERIES[q], engines) is None
    finally:
        _reset(ctxs)


SUM_COUNT = "SELECT k{G}, sum(q), count(*) FROM g GROUP BY k{G}"
MIN_MAX = "SELECT k{G}, min(v), max(v) FROM g GROUP BY k{G}"


@pytest.mark.parametrize("setting,caps,inside,outside", [
    ("device_scan_agg_max_groups", {}, "mask", "matmul"),
    ("device_scan_agg_max_groups_matmul",
     {"device_scan_agg_max_groups": 0}, "matmul", "sort"),
    ("device_scan_agg_max_groups_sort",
     {"device_scan_agg_max_groups": 0,
      "device_scan_agg_max_groups_matmul": 0}, "sort", None),
])
def test_group_cap_edge(ctxs, engines, setting, caps, inside, outside):
    """A grid of exactly the cap's G takes the capped engine; one group
    more takes the next engine (the host past the sort engine's cap)."""
    try:
        _set(ctxs, device_scan_agg_min_rows=0, device_scan_agg_max_pull_mb=0,
             **caps, **{setting: 40})
        assert _port_route(ctxs, SUM_COUNT.format(G=40), engines) == inside
        assert _port_route(ctxs, SUM_COUNT.format(G=41), engines) == outside
    finally:
        _reset(ctxs)


def test_mask_cap_edge_min_max(ctxs, engines):
    """MIN / MAX past the mask engine's cap take the sort engine."""
    try:
        _set(ctxs, device_scan_agg_min_rows=0, device_scan_agg_max_groups=40)
        assert _port_route(ctxs, MIN_MAX.format(G=40), engines) == "mask"
        assert _port_route(ctxs, MIN_MAX.format(G=41), engines) == "sort"
    finally:
        _reset(ctxs)


def test_pull_edge(ctxs, engines):
    """The sort engine's unfused [4, G] int32 grid: at G = 65,536 it is
    exactly 1 MB and routes under ``device_scan_agg_max_pull_mb = 1``; one
    group more passes the screen and stays on the host."""
    try:
        _set(ctxs, device_scan_agg_min_rows=0, device_scan_agg_max_groups=0,
             device_scan_agg_max_groups_matmul=0,
             device_scan_agg_max_pull_mb=1)
        assert _port_route(ctxs, SUM_COUNT.format(G=65_536), engines) \
            == "sort"
        assert _port_route(ctxs, SUM_COUNT.format(G=65_537), engines) is None
    finally:
        _reset(ctxs)


def _knn(where=""):
    return (f"SELECT id FROM vt {where}ORDER BY l2_distance(emb, "
            "[1,2,3,-4,0,5,-6,7]) LIMIT 5")


@pytest.mark.parametrize("where", ["", "WHERE id % 3 = 0 "])
def test_host_scan_edge(ctxs, monkeypatch, where):
    """A corpus of exactly the gate's rows is scored on the host; with the
    gate one row lower it is scored by the device route."""
    j, t, _ = ctxs
    calls = []
    real = ttable.FuseTable._host_block_scores
    monkeypatch.setattr(ttable.FuseTable, "_host_block_scores",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        _set(ctxs, vector_search_mode="'exact'")
        for gate, on_host in ((VEC_ROWS, True), (VEC_ROWS - 1, False)):
            _set(ctxs, vector_host_scan_max_rows=gate)
            calls.clear()
            got = t.sql(_knn(where)).rows()
            assert bool(calls) == on_host
            assert got == j.sql(_knn(where)).rows() and len(got) == 5
    finally:
        _set(ctxs, vector_search_mode="'auto'")
        _reset(ctxs)


def test_exact_scan_edge(ctxs):
    """In auto mode a block of exactly the gate's rows takes the exact scan,
    and with the gate one row lower its graph."""
    j, t, _ = ctxs
    try:
        _set(ctxs, vector_host_scan_max_rows=0)
        for gate, graph in ((VEC_ROWS, False), (VEC_ROWS - 1, True)):
            _set(ctxs, vector_exact_scan_max_rows=gate)
            before = TMETRICS.counters.get("hnsw_search_batches", 0)
            got = t.sql(_knn()).rows()
            searched = TMETRICS.counters.get("hnsw_search_batches", 0)
            assert (searched > before) == graph
            assert got == j.sql(_knn()).rows() and len(got) == 5
    finally:
        _reset(ctxs)
