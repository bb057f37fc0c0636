"""HNSW: the port's torch build and beam search against the JAX package's.

Inputs come from numpy seeds; torch runs on the CPU, asked for by name.

* Search, on the SAME graph (built by the JAX package): ids equal,
  distances to rtol 1e-5 / atol 1e-5 (f32 sums of 32 products in another
  order; the ip scores of this corpus reach about 100, so 1e-5 relative).
* Build, on integer-valued vectors with duplicate rows: every bf16 product
  and f32 sum is exact, ties occur by the hundred, and ``links``,
  ``level_ids`` and ``entry_points`` are equal bit for bit.
* The three device programs of the build and the greedy descent, each
  against its JAX counterpart on the same arrays: integer outputs equal,
  distances to rtol 1e-5 (exactly equal on the integer inputs).
* The cases of ``tests/test_hnsw.py`` on the port, with their thresholds
  (recall@10 >= 0.95 at ef = 40, distances atol / rtol 1e-3).
* A graph file written by either package is read and searched by the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from databend_tpu.index.hnsw import HnswGraph as JaxGraph
from databend_tpu.index.hnsw import build as jbuild
from databend_tpu.index.hnsw import build_hnsw as jax_build
from databend_tpu.index.hnsw import hnsw_search as jax_search
from databend_tpu.index.hnsw import search as jsearch

from databend_tpu_torch import backend
from databend_tpu_torch.index.hnsw import HnswGraph, build_hnsw, hnsw_search
from databend_tpu_torch.index.hnsw import build as tbuild
from databend_tpu_torch.index.hnsw import search as tsearch
from databend_tpu_torch.index.hnsw.search import postprocess_scores
from databend_tpu_torch.utils.metrics import METRICS

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_on_cpu(monkeypatch):
    monkeypatch.setenv(backend.DEVICE_ENV, "cpu")


def _normalized(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    # clustered data: harder for graphs than uniform
    centers = rng.normal(size=(20, 32)).astype(np.float32) * 3
    return np.concatenate([
        c + rng.normal(size=(100, 32)).astype(np.float32) for c in centers])


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(11)
    return corpus[rng.choice(2000, 50, replace=False)] + \
        0.05 * rng.normal(size=(50, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_graphs(corpus):
    return {m: jax_build(corpus, m=16, ef_construct=64, metric=m, seed=3)
            for m in ("l2", "cosine", "ip")}


def _int_corpus(n=1500, d=32, seed=5):
    """Small non-negative integers, 100 rows repeated: distances tie, and
    every product and sum is exact in bf16 x bf16 -> f32."""
    x = np.random.default_rng(seed).integers(0, 6, size=(n, d))
    x[100:200] = x[0:100]
    return x.astype(np.float32)


def brute_knn(q, x, k, metric):
    if metric == "cosine":
        d = 1 - _normalized(q) @ _normalized(x).T
    else:
        d = np.sqrt(((q[:, None] - x[None]) ** 2).sum(-1))
    ids = np.argsort(d, axis=1)[:, :k]
    return np.take_along_axis(d, ids, 1), ids


# ---- (a) search on the same graph -----------------------------------------

@pytest.mark.parametrize("b", [1, 50])
@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_search_matches_jax_on_same_graph(corpus, queries, jax_graphs,
                                          metric, b):
    g = jax_graphs[metric]
    x = _normalized(corpus) if metric == "cosine" else corpus
    want_d, want_i = jax_search(g, jnp.asarray(x), queries[:b], k=10)
    got_d, got_i = hnsw_search(g, backend.to_device(x), queries[:b], k=10)
    assert got_d.dtype == np.float32 and got_i.dtype == np.int32
    assert got_d.shape == got_i.shape == (b, 10)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=RTOL, atol=ATOL)


def test_search_counts_its_steps(corpus, queries, jax_graphs):
    before = METRICS.snapshot()
    hnsw_search(jax_graphs["l2"], backend.to_device(corpus), queries[:4], k=10)
    after = METRICS.snapshot()
    assert after["hnsw_search_batches"] \
        - before.get("hnsw_search_batches", 0) == 1
    steps = after["hnsw_search_steps"] - before.get("hnsw_search_steps", 0)
    assert 10 <= steps <= 2 * 40 + 16       # ef = 40: max_steps = 2 ef + 16


# ---- (b) build on integer vectors -----------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_matches_jax_on_integer_vectors(metric):
    x = _int_corpus()
    want = jax_build(x, m=8, ef_construct=40, metric=metric, seed=5)
    got = build_hnsw(x, m=8, ef_construct=40, metric=metric, seed=5)
    assert got.num_levels == want.num_levels >= 3
    np.testing.assert_array_equal(got.entry_points, want.entry_points)
    for l in range(want.num_levels):
        assert got.links[l].dtype == np.int32
        np.testing.assert_array_equal(got.links[l], want.links[l])
        if l:
            np.testing.assert_array_equal(got.level_ids[l], want.level_ids[l])
    assert got.level_ids[0] is None
    if metric == "l2":
        # the duplicates did tie: a repeated row's nearest is its twin
        assert (got.links[0][100:200, 0] == np.arange(100)).all()


def test_build_records_stage_seconds():
    before = METRICS.snapshot()
    build_hnsw(_int_corpus(300, 8), m=4, ef_construct=16, metric="l2")
    after = METRICS.snapshot()
    for stage in tbuild.BUILD_STAGES:
        key = f"hnsw_build_{stage}_seconds_count"
        assert after[key] - before.get(key, 0) == 1, stage


# ---- (c) the programs of the build and the descent ------------------------

def _knn_inputs(metric, n=600, k=24):
    x = _int_corpus(n, 16, seed=9)
    d, i = jbuild._knn_graph_np(jnp.asarray(x), n, k, metric)
    return x, d, i


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_knn_graph_matches_jax(metric):
    x, want_d, want_i = _knn_inputs(metric)
    got_d, got_i = tbuild._knn_graph_np(backend.to_device(x), len(x), 24,
                                        metric, q_chunk=256, chunk_rows=250)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_heuristic_prune_matches_jax(metric):
    x, d, i = _knn_inputs(metric)
    i[5, 20:] = -1                        # a row with padding
    d[5, 20:] = np.inf
    pids = np.arange(len(x), dtype=np.int32)
    cd = jbuild._prep_for_metric(d, metric)
    want = jbuild._heuristic_prune(jnp.asarray(x), jnp.asarray(cd),
                                   jnp.asarray(i), jnp.asarray(pids), 8, metric)
    got = tbuild._heuristic_prune(
        backend.to_device(x), backend.to_device(tbuild._prep_for_metric(d, metric)),
        backend.to_device(i), backend.to_device(pids), 8, metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).sum(1).min() >= 1


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_dedup_sort_matches_jax(metric):
    rng = np.random.default_rng(13)
    x = _int_corpus(400, 16, seed=13)
    ids = rng.integers(-1, 400, size=(400, 24)).astype(np.int32)
    ids[:, 7] = ids[:, 2]                 # a repeated id in every row
    ids[::3, 4] = np.arange(400, dtype=np.int32)[::3]   # self links
    pids = np.arange(400, dtype=np.int32)
    want_d, want_i = jbuild._dedup_sort_kernel(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(pids), metric)
    got_d, got_i = tbuild._dedup_sort_kernel(
        backend.to_device(x), backend.to_device(ids), backend.to_device(pids),
        metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL)


def test_reverse_edges_and_levels_match_jax():
    links = np.random.default_rng(3).integers(-1, 300, (300, 8)).astype(np.int32)
    np.testing.assert_array_equal(tbuild._add_reverse_edges(links, None, 8),
                                  jbuild._add_reverse_edges(links, None, 8))
    np.testing.assert_array_equal(tbuild.assign_levels(5000, 16, seed=4),
                                  jbuild.assign_levels(5000, 16, seed=4))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_greedy_descent_matches_jax(corpus, queries, jax_graphs, metric):
    g = jax_graphs[metric]
    assert g.num_levels >= 2
    n = g.num_points
    level_pos = np.full(n, -1, np.int32)
    level_pos[g.level_ids[1]] = np.arange(len(g.level_ids[1]), dtype=np.int32)
    entry = np.full(len(queries), int(g.level_ids[1][0]), np.int32)
    want_i, want_d = jsearch._greedy_descent(
        jnp.asarray(corpus), jnp.asarray(g.links[1]), jnp.asarray(level_pos),
        jnp.asarray(queries), jnp.asarray(entry), metric)
    got_i, got_d = tsearch._greedy_descent(
        backend.to_device(corpus), backend.to_device(g.links[1]),
        backend.to_device(level_pos), backend.to_device(queries),
        backend.to_device(entry), metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=RTOL, atol=ATOL)
    assert (np.asarray(want_i) != entry).any()      # the walk moved


def test_level0_ties_follow_position_order():
    """Equal distances everywhere (every row is the same vector): the
    result is decided by the tie rules alone."""
    x = np.ones((200, 8), np.float32)
    g = jax_build(x, m=4, ef_construct=16, metric="l2", seed=1)
    want_d, want_i = jax_search(g, jnp.asarray(x), x[:3], k=8)
    got_d, got_i = hnsw_search(g, backend.to_device(x), x[:3], k=8)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


# ---- (d) the cases of tests/test_hnsw.py on the port -----------------------

def test_graph_shape_and_levels(corpus):
    g = build_hnsw(corpus, m=8, ef_construct=32, metric="l2", seed=1)
    assert g.num_points == 2000 and g.m0 == 16
    assert g.links[0].shape == (2000, 16)
    assert (g.links[0][:, 0] >= 0).all()            # every point is linked
    assert not (g.links[0] == np.arange(2000)[:, None]).any()   # no self link
    for l in range(1, g.num_levels):
        assert g.links[l].shape == (len(g.level_ids[l]), 8)
    assert len(g.entry_points) >= 1


def test_tiny_block():
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    g = build_hnsw(x, m=4, metric="l2")
    assert g.num_points == 5
    d, ids = hnsw_search(g, backend.to_device(x), x[:2], k=3)
    assert ids[0, 0] == 0 and ids[1, 0] == 1  # self is nearest


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_recall_at_10(corpus, queries, metric):
    g = build_hnsw(corpus, m=16, ef_construct=64, metric=metric, seed=3)
    x = _normalized(corpus) if metric == "cosine" else corpus
    d, ids = hnsw_search(g, backend.to_device(x), queries, k=10)  # ef = 40
    _, want = brute_knn(queries, corpus, 10, metric)
    recall = np.mean([len(set(ids[i].tolist()) & set(want[i].tolist())) / 10
                      for i in range(len(queries))])
    assert recall >= 0.95, f"recall@10 = {recall}"


def test_scores_match_metric(corpus):
    g = build_hnsw(corpus, m=16, ef_construct=64, metric="l2", seed=3)
    q = corpus[:4]
    d, ids = hnsw_search(g, backend.to_device(corpus), q, k=5)
    assert (ids[:, 0] == np.arange(4)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-3)
    for i in range(4):
        true_d = np.linalg.norm(corpus[ids[i, 1]] - q[i])
        np.testing.assert_allclose(d[i, 1], true_d, rtol=1e-3)


def test_cosine_postprocess(corpus):
    g = build_hnsw(corpus, m=16, ef_construct=64, metric="cosine", seed=4)
    d, ids = hnsw_search(g, backend.to_device(_normalized(corpus)),
                         corpus[:3], k=5)
    scores = postprocess_scores(d, "cosine")
    np.testing.assert_allclose(scores[:, 0], 0.0, atol=1e-3)
    assert (scores >= -1e-3).all() and (scores <= 2.001).all()


def test_search_from_compressed_links(corpus):
    x = corpus[:800]
    g = build_hnsw(x, m=8, ef_construct=48, metric="l2", seed=4)
    g2 = HnswGraph.from_bytes(g.to_bytes("compressed"))
    for l in range(g.num_levels):
        assert [frozenset(r[r >= 0].tolist()) for r in g2.links[l]] == \
            [frozenset(r[r >= 0].tolist()) for r in g.links[l]]
    q = x[:8] + 0.01
    x_dev = backend.to_device(x)
    d1, i1 = hnsw_search(g, x_dev, q, k=5, ef=64)
    d2, i2 = hnsw_search(g2, x_dev, q, k=5, ef=64)
    assert (i1[:, 0] == i2[:, 0]).all()


# ---- (e) one file format ---------------------------------------------------

@pytest.mark.parametrize("fmt", ["plain", "compressed"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_file_crosses_packages(corpus, queries, tmp_path, writer, fmt):
    x = corpus[:600]
    path = str(tmp_path / "g.hnsw")
    if writer == "jax":
        g = jax_build(x, m=8, ef_construct=32, metric="l2", seed=2)
        g.save(path, format=fmt)
        loaded = HnswGraph.load(path)
        got = hnsw_search(loaded, backend.to_device(x), queries[:8], k=5)
        want = jax_search(JaxGraph.load(path), jnp.asarray(x), queries[:8], k=5)
    else:
        g = build_hnsw(x, m=8, ef_construct=32, metric="l2", seed=2)
        g.save(path, format=fmt)
        loaded = JaxGraph.load(path)
        want = jax_search(loaded, jnp.asarray(x), queries[:8], k=5)
        got = hnsw_search(HnswGraph.load(path), backend.to_device(x),
                          queries[:8], k=5)
    assert loaded.metric == "l2" and loaded.m == 8
    assert loaded.links[0].shape == g.links[0].shape
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL, atol=ATOL)


# ---- the port's recall is the reference's, on the smoke run's corpus -------

def test_recall_equals_jax_on_sift_like_block():
    """A block of the on-card smoke run's corpus shape (128-d integer
    values in [0, 255], clusters of 256 rows with Gaussian noise sd 24,
    cosine, m = 16, ef_construct = 100, ef = 40), cut to 8,192 rows: float
    data, so near-ties may reorder a few kNN lists (bf16 scores summed in
    another order) and the graphs need not be equal, but at least 99% of
    the level-0 rows are, and both packages reach the same recall@10
    (within 0.02; 0.9547 for both when this was written)."""
    rng = np.random.default_rng(23)
    centers = rng.integers(0, 256, size=(32, 128)).astype(np.float32)

    def sift_like(n):
        c = centers[rng.integers(0, 32, size=n)]
        noise = rng.standard_normal((n, 128), dtype=np.float32) * 24.0
        return np.clip(np.rint(c + noise), 0, 255)

    x, q = sift_like(8192), sift_like(64)
    xn, qn = _normalized(x), _normalized(q)
    truth = np.argsort(1 - qn.astype(np.float64) @ xn.astype(np.float64).T,
                       axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(ids[i].tolist()) & set(truth[i].tolist())) / 10
                        for i in range(len(q))])

    gj = jax_build(x, m=16, ef_construct=100, metric="cosine")
    gt = build_hnsw(x, m=16, ef_construct=100, metric="cosine")
    assert (gj.links[0] == gt.links[0]).all(axis=1).mean() >= 0.99
    _, ij = jax_search(gj, jnp.asarray(xn), q, k=10)
    _, it = hnsw_search(gt, backend.to_device(xn), q, k=10)
    rj, rt = recall(np.asarray(ij)), recall(it)
    assert rt >= 0.9 and abs(rt - rj) <= 0.02, (rt, rj)
