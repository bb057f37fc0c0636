"""The port never imports jax or the databend_tpu package.

The slice runs in a subprocess (tests/conftest.py imports jax into this
one) behind a ``sys.meta_path`` blocker on jax, jaxlib and databend_tpu;
afterwards no such module may be loaded, and every port module must have
been loaded from the port's own directory. ``test_torch_standalone.py``
runs the same script from a copy of the port alone.
"""

import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "databend_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
sys.path.insert(0, REPO)

import contextlib
import io
import os
import runpy
import tempfile
import numpy as np
import databend_tpu_torch as dt
from databend_tpu_torch.expression import Column, DataBlock
from databend_tpu_torch.types import VectorType

n, d = 5000, 16
rng = np.random.default_rng(0)
x = rng.standard_normal((n, d)).astype(np.float32)
with tempfile.TemporaryDirectory() as root:
    ctx = dt.SessionContext(root)
    ctx.sql(f"CREATE TABLE t (id BIGINT, emb VECTOR({d})) ROW_PER_BLOCK='4096'")
    ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2,cosine'")
    ctx.insert_block("t", DataBlock(
        ["id", "emb"], [Column.from_numpy(np.arange(n, dtype=np.int64)),
                        Column.from_numpy(x, VectorType(d))]))
    ctx.sql("SET vector_host_scan_max_rows = 0")
    lit = "[" + ",".join("%.5f" % v for v in x[3]) + "]"
    rows = ctx.sql("SELECT id FROM t ORDER BY l2_distance(emb, " + lit
                   + ") LIMIT 5").rows()
    assert rows[0] == (3,), rows
    ctx.sql("SELECT id, cosine_distance(emb, " + lit + ") AS s FROM t "
            "ORDER BY s LIMIT 5").rows()
    ps = ctx.prepare("SELECT id FROM t ORDER BY l2_distance(emb, ?) LIMIT 10")
    assert ps.execute_batch(x[:4])[2].rows()[0] == (2,)
    for exact in (True, False):
        blk = ps.execute_batch_block(x[:300], exact=exact)
        assert blk.rows()[10] == (1, 1), blk.rows()[10]
    fps = ctx.prepare("SELECT id FROM t WHERE id < ? "
                      "ORDER BY cosine_distance(emb, ?) LIMIT 10")
    assert fps.execute_batch([(100, x[5])], exact=False)[0].rows()[0] == (5,)
    # aggregates consult the relational device routes; below the size gate
    # (device_scan_agg_min_rows) the host answers
    from databend_tpu_torch.utils.metrics import METRICS
    agg = ("SELECT id % 3 AS g, count(*), sum(id) FROM t "
           "WHERE id < 4000 GROUP BY g ORDER BY g")
    got = ctx.sql(agg).rows()
    ids = np.arange(4000)
    assert got == [(g, int((ids % 3 == g).sum()), int(ids[ids % 3 == g].sum()))
                   for g in range(3)], got
    # with the gate at 0 the scan-aggregate route answers from the device
    routed = METRICS.snapshot().get("device_scan_agg_queries", 0)
    ctx.sql("SET device_scan_agg_min_rows = 0")
    assert ctx.sql(agg).rows() == got
    assert METRICS.snapshot()["device_scan_agg_queries"] == routed + 1
    assert "databend_tpu_torch.ops.grouped_sums" in sys.modules
    ctx.sql("SET device_scan_agg_min_rows = 300000")
    got = ctx.sql("SELECT id % 7 AS g, count(*) AS c FROM t GROUP BY g "
                  "HAVING count(*) > 714 ORDER BY c DESC, g LIMIT 2").rows()
    assert got == [(0, 715), (1, 715)], got
    assert "databend_tpu_torch.pipeline.device_scan_agg" in sys.modules
    # above a size gate of 4,000 rows: a top-n finished by the finalize
    # fusion on the grid, and a join answered by dictionary enrichment (J1)
    from databend_tpu_torch.pipeline import device_fusion
    ctx.sql("SET device_scan_agg_min_rows = 4000")
    fused = []
    real_fusion = device_fusion.run_fusion
    device_fusion.run_fusion = lambda *a: fused.append(1) or real_fusion(*a)
    top = ctx.sql("SELECT id % 7 AS g, sum(id) AS s FROM t GROUP BY g "
                  "ORDER BY s DESC LIMIT 2").rows()
    device_fusion.run_fusion = real_fusion
    every = np.arange(n)
    want = sorted(((int(every[every % 7 == g].sum()), g) for g in range(7)),
                  reverse=True)
    assert fused and top == [(g, s) for s, g in want[:2]], top
    ctx.sql("CREATE TABLE dd (k BIGINT, name VARCHAR)")
    ctx.sql("INSERT INTO dd VALUES (1, 'one'), (2, 'two'), (3, 'three'), "
            "(4, 'two')")
    joined = METRICS.snapshot().get("device_join_agg_queries", 0)
    by_name = ctx.sql("SELECT name, count(*), sum(id) FROM t JOIN dd "
                      "ON id = k GROUP BY name ORDER BY name").rows()
    assert by_name == [("one", 1, 1), ("three", 1, 3), ("two", 2, 6)], \
        by_name
    assert METRICS.snapshot()["device_join_agg_queries"] == joined + 1
    ctx.sql("SET device_scan_agg_min_rows = 300000")
    # with the distributed setting on, the executor reaches the port's mesh,
    # gets none, and the host operators give the same answer
    ctx.sql("SET enable_distributed_execution = 1")
    assert ctx.sql("SELECT id % 7 AS g, count(*) AS c FROM t GROUP BY g "
                   "HAVING count(*) > 714 ORDER BY c DESC, g LIMIT 2"
                   ).rows() == got
    assert "databend_tpu_torch.parallel.fragmenter" in sys.modules
    # under an installed mesh of 4 logical shards the fused fragment runs
    # its psum program over the mesh, with the same answer
    import torch
    from databend_tpu_torch.parallel import fragmenter, mesh
    mesh.set_default_mesh(mesh.make_mesh(4, devices=[torch.device("cpu")] * 4))
    frags = []
    real_frag = fragmenter.sharded_grouped_agg_topn
    fragmenter.sharded_grouped_agg_topn = \
        lambda *a, **k: frags.append(1) or real_frag(*a, **k)
    single = ("SELECT id % 7 AS g, sum(id) AS s FROM t GROUP BY g "
              "HAVING count(*) > 714 ORDER BY s DESC LIMIT 2")
    assert ctx.sql(single).rows() == [(1, 1787500), (0, 1786785)]
    mesh.set_default_mesh(None)
    assert frags == [1], frags
    # a process group of one, joined through the meta registry (gloo on the
    # CPU): its mesh of 4 positions answers the same statement
    import socket
    from databend_tpu_torch.meta.cluster import ClusterDiscovery
    from databend_tpu_torch.meta.kv import MetaStore
    from databend_tpu_torch.parallel import multihost
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    meta = MetaStore(os.path.join(root, "cluster.db"))
    node = ClusterDiscovery.local_node(address=f"localhost:{port}")
    ClusterDiscovery(meta).register(node)
    joined_mesh, rank = multihost.join_cluster_mesh(
        meta, node.node_id, 1, timeout=60.0, local_device_count=4)
    assert rank == 0 and joined_mesh.backend == "gloo"
    assert mesh.get_default_mesh() is joined_mesh
    assert not mesh.mesh_spans_processes(joined_mesh)
    assert ctx.sql(single).rows() == [(1, 1787500), (0, 1786785)]
    assert frags == [1, 1], frags
    multihost.leave_cluster_mesh()
    fragmenter.sharded_grouped_agg_topn = real_frag
    ctx.sql("SET enable_distributed_execution = 0")
    # an HNSW graph per block at insert, and the beam search from SQL
    ctx.sql(f"CREATE TABLE h (id BIGINT, emb VECTOR({d})) ROW_PER_BLOCK='1024'")
    ctx.sql("CREATE VECTOR INDEX hv ON h(emb) distance='l2' graphs='always' "
            "m='8' ef_construct='32'")
    ctx.insert_block("h", DataBlock(
        ["id", "emb"], [Column.from_numpy(np.arange(2000, dtype=np.int64)),
                        Column.from_numpy(x[:2000], VectorType(d))]))
    ctx.sql("SET vector_search_mode = 'hnsw'")
    rows = ctx.sql("SELECT id FROM h ORDER BY l2_distance(emb, " + lit
                   + ") LIMIT 5").rows()
    assert rows[0] == (3,), rows
    assert "databend_tpu_torch.index.hnsw.search" in sys.modules
    ctx.sql("SET vector_search_mode = 'auto'")
    # MERGE INTO binds its source through the port's binder
    ctx.sql("CREATE TABLE m (id BIGINT, v BIGINT)")
    ctx.sql("CREATE TABLE s (id BIGINT, v BIGINT)")
    ctx.sql("INSERT INTO m VALUES (1, 1), (2, 2)")
    ctx.sql("INSERT INTO s VALUES (2, 20), (3, 30)")
    ctx.sql("MERGE INTO m USING s ON m.id = s.id WHEN MATCHED THEN UPDATE "
            "SET v = s.v WHEN NOT MATCHED THEN INSERT (id, v) VALUES (s.id, s.v)")
    got = sorted(ctx.sql("SELECT id, v FROM m").rows())
    assert got == [(1, 1), (2, 20), (3, 30)], got
    # the system tables that describe the devices, and a server's node entry
    opts = dict(ctx.sql("SELECT name, value FROM system.build_options").rows())
    assert opts["device_platform"] == "cpu" and opts["device_count"] == "1"
    devs = [r for r in ctx.sql("SELECT name, host FROM system.clusters").rows()
            if r[0].startswith("device-")]
    assert devs == [("device-0", "cpu")], devs
    from databend_tpu_torch.meta.cluster import ClusterDiscovery
    assert ClusterDiscovery.local_node().device_count == 1
    credits = dict(ctx.sql("SELECT * FROM system.credits").rows())
    assert "torch" in credits and "jax" not in credits, credits
    # CLUSTER BY over a vector column: k-means on torch
    ctx.sql(f"CREATE TABLE c (id BIGINT, emb VECTOR({d}), VECTOR INDEX cv "
            "(emb) distance='l2') CLUSTER BY (emb) ROW_PER_BLOCK='1024'")
    ctx.insert_block("c", DataBlock(
        ["id", "emb"], [Column.from_numpy(np.arange(3000, dtype=np.int64)),
                        Column.from_numpy(x[:3000], VectorType(d))]))
    rows = ctx.sql("SELECT id FROM c ORDER BY l2_distance(emb, " + lit
                   + ") LIMIT 5").rows()
    assert rows[0] == (3,), rows
    assert "databend_tpu_torch.index.kmeans" in sys.modules
    # a small prepared match() declines to the generic path (host BM25)
    ctx.sql("CREATE TABLE mt (id BIGINT, body VARCHAR)")
    ctx.sql("CREATE INVERTED INDEX mt_i ON mt(body)")
    ctx.sql("INSERT INTO mt VALUES (1, 'red fox'), (2, 'blue whale'), "
            "(3, 'red whale whale')")
    mp = ctx.prepare("SELECT id FROM mt WHERE match(body, ?) "
                     "ORDER BY score() DESC LIMIT 2")
    assert mp.execute("whale").rows() == [(3,), (2,)]
    assert mp._match._snap_id is None
    # above the device threshold the match server answers from the device
    # BM25 scorers: a text batch and a fused text+vector batch
    from databend_tpu_torch.index.inverted.device import ImpactBM25
    from databend_tpu_torch.service.prepared import _MatchServer
    from databend_tpu_torch.types import String
    nb = _MatchServer.DEVICE_MIN_DOCS + 480
    words = np.array(["red", "fox", "blue", "whale", "crab", "hill", "sea"])
    picks = words[rng.integers(0, len(words), (nb, 3))]
    bodies = [" ".join(p) for p in picks]
    bodies[7] = "whale whale whale"
    ctx.sql(f"CREATE TABLE big (id BIGINT, body VARCHAR, emb VECTOR({d})) "
            "ROW_PER_BLOCK='2048'")
    ctx.sql("CREATE INVERTED INDEX big_i ON big(body)")
    xb = rng.standard_normal((nb, d)).astype(np.float32)
    ctx.insert_block("big", DataBlock(
        ["id", "body", "emb"],
        [Column.from_numpy(np.arange(nb, dtype=np.int64)),
         Column.from_pylist(bodies, String),
         Column.from_numpy(xb, VectorType(d))]))
    bp = ctx.prepare("SELECT id FROM big WHERE match(body, ?) "
                     "ORDER BY score() DESC LIMIT 3")
    got = bp.execute_batch(["whale", "red fox", "nosuchword"])
    assert bp._match._snap_id is not None
    assert [type(s) for s in bp._match._scorers] == [ImpactBM25] * 2
    assert len(got[0].rows()) == 3 and got[2].rows() == []
    for text, res in zip(["whale", "red fox"], got):
        assert res.rows() == ctx.sql(
            "SELECT id FROM big WHERE match(body, '" + text + "') "
            "ORDER BY score() DESC LIMIT 3").rows(), text
    fp = ctx.prepare("SELECT id FROM big WHERE match(body, ?) ORDER BY "
                     "0.04 * score() - cosine_distance(emb, ?) DESC LIMIT 3")
    got = fp.execute_batch([("whale", list(map(float, xb[7]))),
                            ("crab sea", list(map(float, xb[11])))])
    assert fp._match._snap_id is not None and len(fp._match._embs) == 2
    assert got[0].rows()[0] == (7,), got[0].rows()
    assert "databend_tpu_torch.index.inverted.device" in sys.modules
    assert "databend_tpu_torch.ops.impact_bm25" in sys.modules
    ctx.close()

# the entry point
sys.argv = ["databend_tpu_torch", "version"]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module("databend_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert out.getvalue().startswith("databend_tpu_torch v"), out.getvalue()

port_dir = os.path.join(os.path.realpath(REPO), "databend_tpu_torch") + os.sep
strays = sorted(m for m, mod in list(sys.modules.items())
                if m.startswith("databend_tpu_torch")
                and getattr(mod, "__file__", None)
                and not os.path.realpath(mod.__file__).startswith(port_dir))
print("STRAYS", strays)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "databend_tpu"))
print("LOADED", bad)
print("PORT_MODULES", sum(m.startswith("databend_tpu_torch") for m in sys.modules))
"""


def run_slice_script(root: str, cwd: str = None) -> None:
    """Run the slice script against the ``databend_tpu_torch`` under
    ``root`` in a fresh interpreter (torch on the CPU) and check what it
    loaded."""
    env = dict(os.environ, DATABEND_TORCH_DEVICE="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("REPO", repr(root))],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout, out.stdout
    assert "STRAYS []" in out.stdout, out.stdout
    n_port = int(re.search(r"PORT_MODULES (\d+)", out.stdout).group(1))
    assert n_port > 50          # the port's own host layers


def test_slice_runs_without_jax():
    run_slice_script(REPO)


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import databend_tpu\b(?!_)"
                     r"|from databend_tpu\b(?!_))", re.M)
    hits = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "databend_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    if pat.search(fh.read()):
                        hits.append(path)
    assert hits == []


def _public_names(path: str) -> set:
    """The public top-level functions and classes a module defines."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def test_unported_jax_modules_ratchet():
    """Reference modules that import jax and are not ported yet (ROADMAP
    "Port state"); the count only goes down. A module counts as ported only
    when the port's file exists and defines every public top-level function
    and class the reference module defines, so a declining stub still
    counts."""
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    ref = os.path.join(REPO, "databend_tpu")
    left = []
    for dirpath, _, files in os.walk(ref):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, ref)
            if not f.endswith(".py"):
                continue
            with open(path, encoding="utf-8") as fh:
                if not pat.search(fh.read()):
                    continue
            port = os.path.join(REPO, "databend_tpu_torch", rel)
            if not os.path.exists(port) \
                    or not _public_names(path) <= _public_names(port):
                left.append(rel)
    assert left == [], sorted(left)
