"""The port's approximate KNN serving (``execute_batch_block(...,
exact=False)``) against the plain approximate route of the benchmark's
reference (``portbench/reference/approx_knn.py``) and its recall judge
(``portbench/reference/knn_recall.py``), at a small size: 40,000 x 128
rows in 3 tiles of 16,384, batches of 512 queries (two chunks), k = 10.

On whole-number rows up to 255 (SIFT's) the bf16 scan is exact, so the
served rows are the true top 10 up to ties; on float rows it is not, and
the recall the judge reports is what bf16 rounding costs (more than the
configuration's limit, which is set for whole-number rows). The port runs on
the CPU here (``DATABEND_TORCH_DEVICE=cpu``): the plain group-min scan, the
same contract as the card's kernel. Each session has a ``memory://`` root
of its own.
"""

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from databend_tpu_torch import backend
from databend_tpu_torch.ops import flash_topk as tflash
from databend_tpu_torch.service.session import SessionContext
from databend_tpu_torch.utils import tracing
from databend_tpu_torch.utils.metrics import METRICS
from portbench.data import clustered
from portbench.reference import approx_knn, knn_recall

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "portbench", "configs", "sift1m-ann.json")
N, Q, B, K = 40000, 512, 512, 10
KNN = ("SELECT id, l2_distance(emb, ?) AS d FROM t "
       "ORDER BY l2_distance(emb, ?) LIMIT 10")
CPU = torch.device("cpu")
_ROOTS = itertools.count()


def _config(integer: bool) -> dict:
    """The benchmark's ``sift1m-ann`` at this file's size; float rows are
    the same clusters, not rounded."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg = dict(cfg, rows=N, queries=Q)
    cfg["ddl"] = [s.replace("262144", "16384") for s in cfg["ddl"]]
    cfg["data"] = dict(cfg["data"], integer=integer)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(autouse=True)
def _drain_span_rings():
    tracing.RECORDER.drain()
    yield
    tracing.RECORDER.drain()


@pytest.fixture(scope="module")
def sessions():
    """``sessions(kind)``: (config, data, a session over table ``t`` of the
    rows) for ``kind`` "whole" or "float", each made once a module."""
    made = {}

    def get(kind):
        if kind not in made:
            cfg = _config(kind == "whole")
            data = clustered.make(cfg, 2**31 + 25, CPU)
            ctx = SessionContext(f"memory://torch-approx-{os.getpid()}-"
                                 f"{next(_ROOTS)}")
            clustered.load(ctx, cfg, data)
            made[kind] = (cfg, data, ctx)
        return made[kind]
    yield get
    for _, _, ctx in made.values():
        ctx.close()


@pytest.fixture(params=["whole", "float"])
def served(request, sessions):
    """(rows kind, config, data, session) for each kind of rows."""
    return (request.param,) + sessions(request.param)


def _answer(ctx, queries, exact=False, sql=KNN):
    res = ctx.prepare(sql).execute_batch_block([(v, v) for v in queries],
                                               exact=exact)
    blk = res.block
    return (np.asarray(blk.column("id").numpy()).reshape(len(queries), -1),
            np.asarray(blk.column("d").numpy()).reshape(len(queries), -1))


def _block(ids, d):
    b, k = ids.shape
    return {"pool": np.arange(b), "query_index": np.repeat(np.arange(b), k),
            "id": ids.reshape(-1), "d": d.reshape(-1)}


def test_served_equals_the_plain_route(served, monkeypatch):
    kind, cfg, data, ctx = served
    launches = []
    real = tflash.flash_group_minima
    monkeypatch.setattr(tflash, "flash_group_minima",
                        lambda *a, **k: launches.append(1) or real(*a, **k))
    ids, d = _answer(ctx, data["queries"][:B])
    assert len(launches) == B // cfg["approx"]["query_chunk"]
    want_ids, want_d = approx_knn.Approx(
        data["rows"], cfg["approx"], CPU).search(data["queries"][:B], K)
    assert np.array_equal(ids, want_ids), kind
    assert np.array_equal(d, want_d), kind


def test_the_last_row_is_served_once(sessions):
    """The last tile's groups end in padding rows. A query at the last real
    row shortlists its group, whose padding members must not score as
    copies of that row (they once did: the row served up to ten times)."""
    cfg, data, ctx = sessions("whole")
    q = np.concatenate([np.repeat(data["rows"][-1:], 8, 0),
                        data["queries"][:B - 8]])
    ids, d = _answer(ctx, q)
    assert (ids[:8, 0] == N - 1).all() and (d[:8, 0] == 0).all()
    assert all(len(set(row)) == K for row in ids.tolist())
    want_ids, want_d = approx_knn.Approx(data["rows"], cfg["approx"],
                                         CPU).search(q, K)
    assert np.array_equal(ids, want_ids) and np.array_equal(d, want_d)


def test_recall_against_the_float64_truth(served):
    kind, cfg, data, ctx = served
    ids, d = _answer(ctx, data["queries"][:B])
    numbers, failed = knn_recall.judge([_block(ids, d)], data, cfg, CPU)
    assert failed == 0 and numbers["malformed"] == 0
    assert numbers["answered"] == B
    if kind == "whole":
        # the route is exact here: the configuration's limit holds it
        assert numbers["recall_shortfall"] == 0.0
        assert numbers["recall_shortfall"] <= cfg["limits"]["recall_shortfall"]
    else:
        # bf16 rounding loses rows near the 10th distance. The limit is the
        # whole-number deployment's; float rows are held to recall@10 of
        # at least 0.9, ann-benchmarks' customary operating point
        assert 0.0 < numbers["recall_shortfall"] < 0.1
    assert numbers["dist_err"] <= cfg["limits"]["dist_err"]


FILTERED = ("SELECT id, l2_distance(emb, ?) AS d FROM t WHERE id < ? "
            "ORDER BY l2_distance(emb, ?) LIMIT 10")
L1 = ("SELECT id, l1_distance(emb, ?) AS d FROM t "
      "ORDER BY l1_distance(emb, ?) LIMIT 10")


@pytest.mark.parametrize("case", ["one_chunk", "filtered", "l1"])
def test_exact_program_serves_and_counts(sessions, case, monkeypatch):
    """An approximate batch of one chunk, a filtered one and one under a
    metric the flash route does not take are served by the exact program,
    with the exact answer, and count under ``knn_approx_exact``."""
    cfg, data, ctx = sessions("whole")
    if case == "l1":
        ctx.sql("CREATE VECTOR INDEX tv1 ON t(emb) distance='l1'")
    launches = []
    real = tflash.flash_group_minima
    monkeypatch.setattr(tflash, "flash_group_minima",
                        lambda *a, **k: launches.append(1) or real(*a, **k))
    q = data["queries"][:256 if case == "one_chunk" else B]
    before = METRICS.snapshot()
    if case == "filtered":
        stmt = ctx.prepare(FILTERED)
        sets = [(v, N, v) for v in q]
        got = stmt.execute_batch_block(sets, exact=False).rows()
        want = stmt.execute_batch_block(sets, exact=True).rows()
    else:
        sql = L1 if case == "l1" else KNN
        got = ctx.prepare(sql).execute_batch_block(
            [(v, v) for v in q], exact=False).rows()
        want = ctx.prepare(sql).execute_batch_block(
            [(v, v) for v in q], exact=True).rows()
    after = METRICS.snapshot()
    assert launches == [] and got == want
    assert after["knn_approx_exact"] - before.get("knn_approx_exact", 0) == 1
    assert after.get("knn_flash_batches", 0) \
        == before.get("knn_flash_batches", 0)


def test_spans_and_counters_of_the_flash_route(sessions):
    cfg, data, _ = sessions("whole")
    ctx = SessionContext(f"memory://torch-approx-{os.getpid()}-"
                         f"{next(_ROOTS)}")
    try:
        clustered.load(ctx, cfg, data)
        stmt = ctx.prepare(KNN)
        sets = [(v, v) for v in data["queries"][:B]]
        chunks = B // cfg["approx"]["query_chunk"]
        stmt.execute_batch_block(sets, exact=True)      # loads the corpus
        for first in (True, False):
            tracing.RECORDER.drain()
            before = METRICS.snapshot()
            stmt.execute_batch_block(sets, exact=False)
            spans = tracing.RECORDER.drain()
            after = METRICS.snapshot()
            launch = next(s for s in spans if s.name == "knn_launch")
            by = {n: [s for s in spans if s.name == n]
                  for n in ("knn_flash_scan", "knn_rerank", "knn_flash_state")}
            for name in ("knn_flash_scan", "knn_rerank"):
                assert [s.attrs["chunk"] for s in by[name]] \
                    == list(range(chunks))
                assert all(s.parent is launch for s in by[name])
            assert all(s.attrs["shortlist"] == 2 * K
                       for s in by["knn_rerank"])
            # the bf16 corpus is built at the first approximate call only
            assert len(by["knn_flash_state"]) == int(first)
            assert all(s.path().startswith("knn_batch/knn_launch/")
                       for s in by["knn_flash_state"])
            assert after["knn_flash_batches"] \
                - before.get("knn_flash_batches", 0) == 1
            assert after.get("knn_approx_exact", 0) \
                == before.get("knn_approx_exact", 0)
        counted = dict(ctx.sql(
            "SELECT metric, value FROM system.metrics").rows())
        assert counted["knn_flash_batches"] >= 2
        assert "databend_tpu_knn_flash_batches " in METRICS.prometheus_text()
    finally:
        ctx.close()


_NO_JAX = r"""
import os, sys
sys.path.insert(0, {repo!r})

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "databend_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Block())
os.environ["DATABEND_TORCH_DEVICE"] = "cpu"
import json
import numpy as np
import torch
import databend_tpu_torch as port
from portbench.data import clustered
from portbench.reference import approx_knn, knn_recall
cfg = json.load(open({config!r}))
cfg = dict(cfg, rows=20000, queries=300)
cfg["ddl"] = [s.replace("262144", "16384") for s in cfg["ddl"]]
data = clustered.make(cfg, 3, torch.device("cpu"))
ctx = port.SessionContext("memory://torch-approx-nojax")
clustered.load(ctx, cfg, data)
res = ctx.prepare({sql!r}).execute_batch_block(
    [(v, v) for v in data["queries"]], exact=False)
ids, _ = approx_knn.Approx(data["rows"], cfg["approx"],
                           torch.device("cpu")).search(data["queries"], 10)
assert np.array_equal(np.asarray(res.block.column("id").numpy()),
                      ids.reshape(-1))
print("FOREIGN", sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"jax", "jaxlib", "flax", "databend_tpu"}}))
"""


def test_no_jax_module_is_loaded():
    code = _NO_JAX.format(repo=REPO, config=CONFIG, sql=KNN)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "FOREIGN []"
