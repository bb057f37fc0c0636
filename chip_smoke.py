"""Drive the port's serving paths once on one CUDA card: exact and
approximate KNN, SQ-u8 scoring, BM25 text and hybrid text+vector serving,
the HNSW index (graph build at insert, beam search from SQL), the device
scan-aggregate route (GROUP BY over card-resident columns), the
join-aggregate route with the finalize fusion (TPC-H joins, HAVING and
top-n on the card), distributed SQL over a mesh of shards and the
multi-shard exact top-k, in one process and across query processes.

    python3 chip_smoke.py [--profile] [--diagnose]
    python3 chip_smoke.py --multihost     # [multihost] alone (see 11)
    python3 chip_smoke.py --gates [OUT]   # the route-gate sweep alone (8b)

Phases (any failure exits non-zero and prints no result line):
  1. the card: name, power limit, torch and CUDA versions;
  2. build the hand-written kernels from databend_tpu_torch/csrc/, one nvcc
     per source, all started together; ptxas must report no spill;
  3. each kernel against its plain PyTorch version, timed with CUDA events
     beside its bound (one read of its inputs and one write of its output at
     3.35 TB/s, or its operations at the card's peak for their type,
     whichever is larger):
     flash_group_minima (atol FLASH_TOL * max |score|, the same +inf pattern
     on pad rows; bf16 FLOPs at 989 TFLOP/s): at the serving shapes (1M x 128
     corpus padded to the flash tile, l2 and ip, B = 256 as the server
     launches it, B = 1024, and B = 300 with a partial last query block), at
     wide embeddings (D in {400, 768, 1536}), and on a 262,144-row corpus
     with tile = 4096, tile = 128 (one step per tile; 300 more launches must
     repeat the first bit for bit) and D = 48;
     flash_rerank ([rerank]: its bound one read of the group minima and of
     every shortlisted row, one write of the [B, k] answer at 3.35 TB/s;
     shortlist 2k, queries at rows of the corpus moved by whole numbers):
     the serving chunk (B = 256 against 1M x 128 whole-number rows, k = 10,
     n_valid inside the last tile, the last real row served once; 50 more
     launches must repeat the first bits) under l2 and ip, ids equal and
     values bit-equal; float rows under l2 and ip (values within
     RERANK_ULPS f32 ulps of the sum of their terms' magnitudes, ids equal
     but between distances that near); rows of 16 values in {0, 1} (ties by
     the thousand in the minima and in the re-rank), D = 960, D = 130
     (scalar loads), a corpus of one tile and k = 100, bit-equal;
     impact_bm25_scores (bit-equal to its plain version, and rtol
     IMPACT_RTOL on finite scores with the same -inf pattern; its bound
     reads sat only at the slots some query term asks for, and counts one
     f32 product at 67 TFLOP/s and one f64 sum at half that rate per
     (query, doc, real query term);
     its plan printed: units of queries, chunks of terms, sub-strips of a
     strip, blocks a unit's items): on a
     block of 262,144 docs at (L = 8, b = 128, m = 4) OR and AND, the same
     fused with a D = 128 distance term (cosine and l2), (L = 8, b = 8),
     (L = 64, b = 128, m = 8), (L = 512, b = 8, m = 4), b = 1, and a block
     that ends in 1,000 pad docs; 300 more launches at (L = 8, b = 8) and
     (L = 8, b = 128) must repeat the first bit for bit; a block where every
     doc has the same terms (every row of the output one value); a block
     whose docs hold one set of (idf, saturation) products at other query
     positions (every score one value: the sum is in f64); batches
     whose vocabulary takes more than one unit: (L = 8, b = 128, m = 16,
     groups of two terms), four units, and (L = 64, b = 16, m = 128, 100
     real terms a query), two units of two chunks; the fused cosine shape at
     an odd n_pad (unaligned rows);
     impact_bm25_topk, the selecting entry point of the same source (ids
     equal and values bit-equal to its plain version at k = 1, 10 and its
     largest k; its bound the function's work, whatever design runs it:
     one read of the layout (sat only at the slots some query term asks
     for, as for the scores), the query operands and the distance term plus
     the [b, k] result at 3.35 TB/s, or one f32 product and one f64 sum
     per (query, doc, real query term) at 67 and 33.5 TFLOP/s and one key
     compare per (query, doc) at the int32 rate; beside it the first
     design's count, one
     compare-select per (real doc slot, real query term), the pair it
     replaces, impact_bm25_scores and the tie-rule top-k, and its plan):
     at the same nine shapes, the serving shape 300 times over, a block
     where every doc has the same terms, the block of one product set at
     other query positions (the top k its lowest matched rows), and AND
     queries with groups no doc matches;
     grouped_sums (bit-equal, beside one index_add_ into int32, the library
     call; one read of ids and value rows and one write of the sums at
     3.35 TB/s; each shape's placement and cluster size printed beside its
     time): n of 6M and 8M, K of 6 and 20 value rows, G of 1, 12, 64 (the
     mask engine), 10,001 and 65,536 (the matmul engine's largest grid)
     and 200,000 (past a cluster of two: the grid in out), the value rows as K tensors of their own against the stacked block at
     the first shape of each placement, 300 repeats at Q1's shape and at
     the first shape spread over a cluster, 65 value rows (two launches),
     every row in one group; after [agg], on the inputs each [agg]
     statement gave it (the route's list of rows);
     exact_topk_select ([exact]: ids equal and values bit-equal to its
     plain version, the masked finish_distance and the tie-rule top-k,
     its plan printed; its bound one read of the product block, the norms
     and the mask and the [b, k] result at 3.35 TB/s, beside torch.topk
     over the finished distances, the library yardstick without the tie
     rule): the serving chunk (b = 256 against 1M x 128
     SIFT-valued rows, k = 10) under l2, cosine and ip, EXACT_REPEATS
     launches each that must repeat the first bits; l2 at k = 1, 128 and
     129 (the composition's route, no launch), a mask a query, one mask row
     for every query, n_valid < N, a ragged N of unaligned rows, one query
     (b = 1); the [ties] blocks (l2, and cosine with a zero query); [mesh]'s
     chunk (b = 8 against 131,072 rows of 96) beside the launch floor (an
     empty kernel's CUDA graph replay); the HNSW build's batch (b = 1,024
     against 65,536 rows, bf16 product) at k = 1, 2, 10, 31, 32, 33, 64,
     96, 97, 101, 127 and 128, k = 101 EXACT_HNSW_REPEATS times, with a mask
     a query and n_valid < N, and on integer rows in [0, 3] (ties across
     the 101st place);
  4. [ties]: exact KNN on tied distances (integer rows in [0, 3], 262,144 x
     128 under l2; rows of a power-of-two norm, 262,144 x 8 under cosine,
     and a zero query: distances exact in f32): 8 literal statements,
     execute_batch at B = 256, execute_batch_block at B = 300 and a
     filtered batch, each query's ids equal to the reference's tie rule
     (ascending distance, equal distances by ascending row id) computed in
     numpy, and exact_topk_select launched once a statement and a query
     chunk; ``ops.topk.topk_smallest_lowest_index`` on the card equal to
     itself on CPU tensors, on a tied block and on one without ties, in
     both of its ways (a row of 262,144 and one of 8,192 distances);
     the main path: SessionContext, CREATE TABLE / VECTOR INDEX, insert of
     1,000,000 SIFT1M-shaped rows (128-d integer values in [0, 255], seed 7),
     a literal KNN query, execute_batch (B=256), execute_batch_block
     (B=1024, exact and approximate; B=256 approximate runs the exact
     program) and a cosine batch; recall@10 against a numpy ground truth on
     16 queries, launch counts of every kernel (exact_topk_select once a
     256-query chunk of an exact batch, the approximate B = 1,024 batches
     none; flash_rerank once a chunk of an approximate batch, the exact
     ones none);
     then [sq8] on the same corpus: ``ops.quantization.encode`` (quantile
     0.99), ``approx_dot`` on [16, N] against the formula over integer
     products in numpy (within 4 f32 ulp of its terms), ``topk_l2`` at
     B = 256, k = 10, shortlist 4 without and with the f32 re-rank (whole
     call, device busy, recall@10; >= 0.95 re-ranked), the int8 product's
     exact f32 route beside ``torch._int_mm`` on the same codes (equal;
     a library yardstick, not on the path);
  5. with --profile, after the launch counts are read: torch.profiler over
     3 batches of each execute_batch_block mode (whole call, _topk, device
     busy, the biggest device items), and in the [match] phase over 3
     batches of the text and the fused statement at B = 128;
     with --diagnose, after the kernel phase: two timing-only variants of
     the flash kernel source (one without the wgmma, one without the fold
     into the minima; their results are wrong and the port never loads them)
     beside the kernel, to show which part holds it, and a variant without
     the fence before a stage's release, to show the race the fence closes
     (launches of 2,000 at tile = 128 that leave the plain answer); then
     every placement grouped_sums can take (cluster size x blocks an SM,
     and the grid in out), each bit-equal and timed at n = 6M, K of 6 and
     20, G of 12, 10,001, 65,536, 200,000 and 400,000, the plan's choice
     marked; then exact_topk_select at the four shapes of its redesign
     (the serving chunk at k = 10 and 128, the HNSW build's batch, [mesh]'s
     chunk): a build of its source with -DEXACT_TOPK_DIAG counts the warp
     iterations with a candidate, the keys taken, the cuts and radix
     passes and the final thresholds, and times the call's memset apart
     from its kernel;
  6. [match]: the hybrid deployment of benchmarks/hybrid_serving_bench.py:
     1,000,000 rows in 4 blocks of 262,144 (id, cat, body of 2-4 words from
     a 16-word list, unit-norm 128-d embeddings, seed 17) under an inverted
     index. A prepared ``match()`` statement single, at B = 8 and B = 128,
     and the fused ``0.04 * score() - cosine_distance(emb, ?)`` statement at
     B = 128: each checked against the generic literal path (rows, scores)
     and, for the text statement, a numpy BM25 computed from the texts,
     then timed (median of 5 batches of fresh texts after a warm-up);
     impact_bm25_topk must have been launched once per block and batch,
     impact_bm25_scores never; the device memory a B = 128 text call
     takes above what was resident must stay under one [128, 262,144] f32
     block. Then a prepared ``match()`` and the fused statement with a
     LIMIT one above the selecting kernel's largest k, at B = 8:
     impact_bm25_scores launched once per block each, rows (and the text
     statement's scores) equal to the generic path (the fused statement's
     rows but where the generic ranking values of two ranks lie within
     1e-6: the two paths round the fused value apart). Then queries of 6,
     8, 11 and 14 of the 16 words (seed 18) at LIMIT 10 and 129, text and
     fused, held the same way; a prepared AND ``match()`` batch with '',
     '   ', '!!' (no row) and one two-word query, and '' alone, against the
     generic path; a table of 20,000 of the texts in one block whose last
     doc has 600 distinct words, so the CSR scorer DeviceBM25 serves it on
     the card: a batch of 2-14 words, one alone and token-free AND texts,
     rows and scores equal to the generic path;
  7. [hnsw]: first the port's build and search on the card against the same
     code on CPU tensors (5,000 integer rows with duplicates, and a corpus
     of equal rows: links and ids equal, so the card's sorts, minima and
     scatters tie as the CPU's do). Then 1,000,000 SIFT-shaped rows (64
     clusters, seed 23) in 4 blocks of 262,144 under
     ``CREATE VECTOR INDEX ... distance='cosine' graphs='always'`` (m = 16,
     ef_construct = 100): the insert builds one graph a block on the card
     (seconds per block by stage); with ``vector_search_mode = 'hnsw'``,
     EXPLAIN shows ``hnsw=on`` and 16 literal ``ORDER BY cosine_distance``
     statements (k = 10, ef = 40) each run one beam search a block, reach
     recall@10 >= HNSW_RECALL against the f64 truth and return the ids of a
     direct ``hnsw_search`` over the loaded graphs merged by hand, whose
     distances are within 1e-3 of the truth; recall@10 by ef over (40, 100,
     200, 400) must not fall and reach HNSW_RECALL_WIDE; then ``hnsw_search`` alone on
     one block at B = 1, 256 and 1,024 (ms per batch, steps; with --profile
     device busy, idle share and device items per step). Nothing here falls
     back to the exact scan or to the CPU; the build's kNN graph launches
     exact_topk_select;
  8. [cluster]: CREATE TABLE ... CLUSTER BY (emb) and an insert of 262,144
     SIFT-shaped rows (the reference's batch of 64 clusters): k-means runs
     on the card, its cluster runs cover every row once, and a KNN query on
     the clustered table reaches recall@10 >= 0.99;
  8b. [gates]: the route gates in force (the scan-aggregate route's table
     size, group caps and pull screen, the host vector scan's size, the
     exact-scan block size, the served-text table size), then TPC-H Q6 over
     lineitem of one row under and of exactly device_scan_agg_min_rows
     rows, and a prepared match() over a table of one doc under and of
     exactly _MatchServer.DEVICE_MIN_DOCS docs: only the second of each pair
     takes its device route, each with the host's (the generic path's)
     rows. With --gates, only the kernels' build and the sweep: each gate
     G1-G7 at the sizes GATES_* give (host and route in turns, each side's
     first call and the median of GATES_REPS warm calls, the whole sweep
     GATES_RUNS times in one process), a [gates] line a gate, size and run,
     every routed statement's rows equal to the host's, then each gate's
     crossover and the default by the rule of gate_rule (the TPU default
     where the crossover lies within half to twice it, else the crossover
     rounded); the whole record as JSON in the file named after --gates
     (build/gates.json by default);
  9. [agg]: TPC-H SF1 lineitem (benchmarks/tpch.py's generator, 6,000,000
     rows, seed 42) and five statements with the route on (its default; the
     group caps and the pull screen at AGG_CAPS, as before the card's caps):
     Q1 and Q6 (mask engine), GROUP BY l_suppkey (10,001 groups, matmul),
     GROUP BY l_partkey (200,001 groups, sort) and COUNT(DISTINCT
     l_suppkey) by l_returnflag. Each: host time (route off), the first
     routed call (builds and uploads the resident forms), the median of 5
     warm calls; one routed query and no route error a call, the expected
     engine, the host's rows (floats within rel 1e-12), and for Q1 / Q6 a
     numpy computation in integer cents. grouped_sums must have launched
     once per routed mask / matmul call. Then Q1 in 4 chunks of 1,500,000
     rows, equal to the one-chunk Q1; with --profile each statement's warm
     call under torch.profiler. Then [tpch] in the same session: the other
     seven tables of the same generator (2.66M rows), every table
     analyzed, and TPC-H q2, q3, q10, q11, q13, q15, q16 and q18 with the
     route defaults but AGG_CAPS: host time, first routed call, the median of 3 warm
     calls; rows equal to the host's and passing ``benchmarks.tpch.check``
     against its pandas ``expected``, no route error; the routes that
     engaged (J1 enrichment, J2 pushdown, the fusion), the engines, any
     decline's reason, grouped_sums launches (added to [agg]'s in the
     kernels line). Then [dist] in the same session under an installed
     mesh of 4 shards (one a card where there are 4 cards, else 4 logical
     shards of cuda:0) with the device-local routes off: a GROUP BY
     (psum merge), HAVING + ORDER BY ... LIMIT by supplier and by part
     (the fused fragment, psum and shuffle), an ORDER BY ... LIMIT 100
     over lineitem (ordered merge), a full ORDER BY over orders
     (range-partition sort), a lineitem-orders join aggregate (broadcast
     join), a row_number() window over orders (key shuffle), each with
     ``enable_distributed_execution`` off then on, twice: the exchange
     called, rows alike (integer-valued columns equal, float sums within
     rel 1e-5), warm times; then a literal l2 KNN statement over 262,144 x
     96 rows with ``enable_distributed_pruning`` off then on: the
     mesh-sharded prune runs, ids equal and equal to numpy;
  10. [mesh]: BASELINE configuration 5 at Deep10M's shape
     (benchmarks/mesh_knn_bench.py): 10,000,000 x 96 standard normal f32
     rows (seed 5) row-sharded over 4 shards (placed as in [dist]), B = 8,
     k = 10, l2: upload s, first and warm batch ms in f32 and bf16, device
     busy of each shard's scan, exact_topk_select launches of the f32
     batches (one a chunk and shard); f32 ids equal to the single-device
     ``chunked_topk_smallest`` and to an f64 numpy truth (recall 1.0),
     distances within 1e-3 x the largest; bf16 recall >= 0.95. Then
     ``sharded_search_step`` on a (2, 2) mesh over 1,048,576 of the rows
     (x 4, rounded: every distance and cluster sum exact) with 64
     centroids: counts equal numpy's and sum to n, centroids within rel
     1e-4 of a numpy Lloyd step, recall@10 1.0;
  11. [multihost]: worker processes of this script (``--multihost-worker``)
     register in a meta store and join one process group through
     ``parallel.multihost.join_cluster_mesh``: 2 ranks sharing cuda:0
     over gloo through host memory (2 positions each), or 4 ranks one card
     each over NCCL where there are 4 cards; the rule must choose that
     backend. Each rank reads only its rows of [mesh]'s corpus (written to
     a .npy by [mesh]) and runs its f32 and bf16 top-10 (ids equal to
     [mesh]'s and the f64 truth, bf16 recall >= 0.95; upload, first and
     warm ms, collective ms, device busy without NCCL's kernels), then
     [dist]'s statements with ``enable_distributed_execution`` on over the
     same TPC-H data root (each exchange called, rows alike [dist]'s). A
     worker that fails or outlives MULTIHOST_TIMEOUT fails the run;
  12. [suites]: ``python -m databend_tpu_torch sqllogic tests/suites/index``
     on the card exits 0;
  13. stand-alone: every loaded port module (the device BM25, HNSW and
     scan-aggregate modules among them) comes from the port's own directory,
     and no jax or databend_tpu module was loaded.
The last line is {"ok": true, "device": {...}}.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_ROWS = 1_000_000
DIM = 128
K = 10
N_GT = 16              # queries with a numpy ground truth
SEED = 7
REPS = 5               # timed batches per serving mode (after one warm-up)
FLASH_TOL = 1e-3       # kernel vs plain: atol FLASH_TOL * max|score| (f32 sums in another order)
RERANK_ULPS = 4        # flash_rerank vs plain on float rows: f32 ulps of the
                       # sum of the terms' magnitudes (sums in another order)
CLUSTER_ROWS = 262_144  # the reference's k-means batch (index/kmeans.py)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor-core peak, same source
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores, data sheet
F64_FLOPS_PER_S = F32_FLOPS_PER_S / 2   # f64 outside the tensor cores: half
IMPACT_RTOL = 1e-6     # kernel vs plain: the same f32 operations in the same order
BLOCK_ROWS = 262_144   # rows per block of the [match] deployment
MATCH_ROWS = 1_000_000
MATCH_SEED = 17
HNSW_ROWS = 1_000_000  # the [hnsw] deployment: blocks of BLOCK_ROWS
HNSW_SEED = 23
HNSW_CENTERS = 64      # clusters of the corpus (the reference's HNSW quality
                       # corpus has 64: native/hnsw_baseline.cpp:190-195)
HNSW_M, HNSW_EF_CONSTRUCT = 16, 100     # the reference's operating point
HNSW_RECALL = 0.80     # recall@10 at ef = 4k = 40 on 16 queries (reads 0.825)
HNSW_EF_SWEEP = (40, 100, 200, 400)
HNSW_RECALL_WIDE = 0.95    # recall@10 at ef = 400 (reads 0.98125)
AGG_SF = 1.0           # the [agg] deployment: TPC-H SF1 (6,000,000 lineitem rows)
AGG_SEED = 42          # benchmarks/tpch.py's default seed
AGG_REPS = 5           # warm routed calls per statement
AGG_CHUNK_ROWS = 1_500_000  # Q1 once more in 4 chunks (the route's default: 8M)
# [agg] and [tpch] keep the engines they covered before the card's caps:
# the defaults measured on the card send every grid above 16 groups to the
# sort engine, which runs no hand kernel
AGG_CAPS = {"device_scan_agg_max_groups": 64,
            "device_scan_agg_max_groups_matmul": 65_536,
            "device_scan_agg_max_pull_mb": 16}
TPCH_QUERIES = ("q2", "q3", "q10", "q11", "q13", "q15", "q16", "q18")
TPCH_REPS = 3          # warm routed calls per [tpch] statement
TIES_ROWS = 262_144    # [ties]: one block of integer rows in [0, 3]
TIES_SEED = 29
SQ8_B = 256            # [sq8]: topk_l2 batch on the main path's corpus
MESH_ROWS = 10_000_000  # [mesh]: BASELINE configuration 5 at Deep10M's shape
MESH_DIM = 96
MESH_SEED = 5
MESH_SHARDS = 4
MESH_B = 8
STEP_ROWS = 1 << 20    # [mesh]: sharded_search_step's corpus
STEP_CENTROIDS = 64
DIST_VEC_ROWS = 262_144  # [dist]: the vector table of the distributed prune
DIST_RTOL = 1e-5       # [dist]: f32 sums of the exchanges against the host's
MULTIHOST_TIMEOUT = 480      # [multihost]: seconds all workers may take
MULTIHOST_GROUP_TIMEOUT = 300  # the workers' process group (each collective)
MATCH_WORDS = ["weather", "news", "google", "maps", "cat", "videos", "python",
               "flights", "hotels", "music", "games", "sports", "stock",
               "market", "recipe", "travel"]
MATCH_LONG_TERMS = (6, 8, 11, 14)   # [match]: words of the tie-heavy queries
CSR_ROWS = 20_000      # [match]: the CSR table, one block above the size gate
CSR_LONG_DOC = 600     # distinct words of its one doc past ImpactBM25.MAX_L


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20) -> float:
    """The device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph and replayed, timed with CUDA events, so that no host time
    lies between the launches (a small launch takes less time on the card
    than its wrapper on the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def sift_like(rng, n, centers):
    """Clustered 128-d vectors rounded to integers in [0, 255], SIFT1M's
    value range; integers this small are exact in bf16."""
    assign = rng.integers(0, centers.shape[0], size=n)
    out = np.empty((n, DIM), np.float32)
    for s in range(0, n, 1 << 18):
        e = min(n, s + (1 << 18))
        noise = rng.standard_normal((e - s, DIM), dtype=np.float32) * 24.0
        out[s:e] = np.clip(np.rint(centers[assign[s:e]] + noise), 0, 255)
    return out


def ground_truth(x, q, metric):
    """Exact top-k by f64 numpy, with the k-th distance for tie-aware recall."""
    x64 = x.astype(np.float64)
    q64 = q.astype(np.float64)
    if metric == "l2":
        d = (x64 * x64).sum(1)[None, :] - 2.0 * (q64 @ x64.T) \
            + (q64 * q64).sum(1)[:, None]
    else:
        xn = x64 / np.maximum(np.linalg.norm(x64, axis=1, keepdims=True), 1e-30)
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        d = 1.0 - qn @ xn.T
    top = np.argpartition(d, K, axis=1)[:, :K]
    kth = np.take_along_axis(d, top, 1).max(1)
    return d, kth


def recall(ids, d, kth):
    """Share of returned ids within the true k-th distance (ties count)."""
    hits = sum(int((d[b, ids[b]] <= kth[b] + 1e-9 * abs(kth[b])).sum())
               for b in range(ids.shape[0]))
    return hits / (ids.shape[0] * K)


def flash_bound(q, xb, nb, tile=16384, lanes=128):
    """(ms, "bytes" or "operations"): the least time one flash_group_minima
    call could take on the card: one read of q, the bf16 corpus and its
    norms plus one write of the [N/T, B, L] f32 minima at the memory rate,
    or its 2*B*N*D bf16 FLOPs at the tensor-core peak, whichever is
    larger."""
    b = q.shape[0]
    n, d = xb.shape
    nbytes = sum(t.numel() * t.element_size() for t in (q, xb, nb)) \
        + (n // tile) * b * lanes * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * n * d / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_flash_kernel(card, metric, q, xb, nb, tile=16384, repeats=0):
    """One launch of flash_group_minima against its plain version on the
    same tensors (FLASH_TOL, same +inf pattern; the corpus ends in pad rows
    with +inf norms), ``repeats`` more launches that must give the same
    bits, then both timed beside the bound.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    from databend_tpu_torch.ops.flash_topk import (
        _flash_group_minima_plain, flash_group_minima)
    b, d = q.shape
    what = f"{metric} B={b} N={xb.shape[0]} D={d} tile={tile}"
    check(bool(torch.isinf(nb[-1])) and not bool(xb[-1].any()),
          f"{what}: the corpus needs pad rows with +inf norms")
    got = flash_group_minima(q, xb, nb, metric, tile=tile)
    torch.cuda.synchronize()
    want = _flash_group_minima_plain(q, xb, nb, metric, tile=tile)
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"{what}: inf pattern differs")
    err = (got[fin] - want[fin]).abs().max().item()
    scale = want[fin].abs().max().item()
    check(err <= FLASH_TOL * scale,
          f"kernel vs plain {what}: {err} > {FLASH_TOL} * {scale}")
    # the kernel is deterministic: a race between its producer and its
    # consumers shows as a launch that differs from the first
    for i in range(repeats):
        again = flash_group_minima(q, xb, nb, metric, tile=tile)
        check(torch.equal(again, got), f"{what}: launch {i + 2} differs from "
                                       "the first")
    del got, want, fin
    ms = cuda_ms(lambda: flash_group_minima(q, xb, nb, metric, tile=tile))
    plain_ms = cuda_ms(
        lambda: _flash_group_minima_plain(q, xb, nb, metric, tile=tile))
    bound_ms, bound_by = flash_bound(q, xb, nb, tile)
    print(f"[kernel] flash_group_minima {what}: max_abs_err {err} (scale "
          f"{scale}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.0f}% reached) "
          f"[{card}]")
    return err, ms, plain_ms, bound_ms, bound_by


def build_kernels():
    """Compile every kernel source, all at once (one nvcc each); print what
    ptxas says and fail on any spill."""
    from concurrent.futures import ThreadPoolExecutor
    from databend_tpu_torch.ops import _cuda
    names = ("flash_group_minima", "impact_bm25_scores", "grouped_sums",
             "exact_topk_select", "flash_rerank")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_cuda.build, names)))
    for name, b in built.items():
        print(f"[build] {name}.cu: nvcc {b['seconds']:.2f} s "
              f"(phase {time.perf_counter() - t0:.2f} s)")
        print(b["log"].strip())
        spills = [ln for ln in b["log"].splitlines() if "spill" in ln]
        check(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                             for ln in spills),
              f"ptxas reports spills in {name}: {spills}")
    check("C7518" not in built["flash_group_minima"]["log"],
          "ptxas serialised the wgmma")


def phase_kernels(card):
    from databend_tpu_torch.ops.flash_topk import pad_for_flash
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}

    # the serving shapes: SIFT-valued rows, 1M x 128 padded to the tile; the
    # chunk the server launches (B = 256), a whole batch (B = 1024) and a
    # ragged batch (B = 300: three query blocks, the last partial)
    x = torch.randint(0, 256, (N_ROWS, DIM), generator=g, device="cuda",
                      dtype=torch.int32).float()
    for metric, batches in (("l2", (256, 1024, 300)), ("ip", (256, 1024))):
        norms = (x * x).sum(1) if metric == "l2" \
            else torch.zeros(N_ROWS, device="cuda")
        xb, nb, _ = pad_for_flash(x.to(torch.bfloat16), norms, 16384)
        for b in batches:
            q = x[torch.randint(0, N_ROWS, (b,), generator=g, device="cuda")] \
                + torch.randn(b, DIM, generator=g, device="cuda")
            results[(metric, b, DIM)] = hold_flash_kernel(card, metric, q, xb, nb)
        del xb, nb, norms
        torch.cuda.empty_cache()
    del x

    # Gaussian rows from here on. Wide embeddings: a last box of 16 valid
    # columns (D = 400) under a partial query block (B = 100), D = 768, 1536
    for metric, b, d in (("l2", 100, 400), ("l2", 256, 768), ("ip", 256, 1536)):
        x = torch.randn(N_ROWS, d, generator=g, device="cuda")
        norms = (x * x).sum(1) if metric == "l2" \
            else torch.zeros(N_ROWS, device="cuda")
        xb, nb, _ = pad_for_flash(x.to(torch.bfloat16), norms, 16384)
        del x, norms
        q = torch.randn(b, d, generator=g, device="cuda")
        results[(metric, b, d)] = hold_flash_kernel(card, metric, q, xb, nb)
        del xb, nb, q
        torch.cuda.empty_cache()

    # small tiles on a 262,144-row corpus: 32 steps per tile, one step per
    # tile, and a single box of 48 valid columns
    for metric, b, d, tile in (("l2", 300, DIM, 4096), ("l2", 300, DIM, 128),
                               ("ip", 100, 48, 4096)):
        n = CLUSTER_ROWS - 1000
        x = torch.randn(n, d, generator=g, device="cuda")
        norms = (x * x).sum(1) if metric == "l2" \
            else torch.zeros(n, device="cuda")
        xb, nb, _ = pad_for_flash(x.to(torch.bfloat16), norms, tile)
        q = torch.randn(b, d, generator=g, device="cuda")
        # one step per tile is where a stage is handed back soonest: 6,123
        # work items a launch, held to the same bits 300 times over
        results[(metric, b, d, tile)] = hold_flash_kernel(
            card, metric, q, xb, nb, tile, repeats=300 if tile == 128 else 0)
        del x, norms, xb, nb, q
    torch.cuda.empty_cache()
    return results


def f32_ulp(t):
    return torch.nextafter(t, torch.full_like(t, float("inf"))) - t


def hold_flash_rerank(card, what, minima, q, x, k, metric, n_valid=None,
                      exact=True, repeats=0, tile=16384):
    """One flash_rerank launch (shortlist 2k) against _flash_rerank_plain on
    the same tensors. ``exact`` (whole-number rows: every product and sum
    exact in f32): ids equal and values bit-equal. Otherwise values within
    RERANK_ULPS f32 ulps of the sum of their terms' magnitudes (the value
    itself under l2, sum |x q| under ip: the sums run in another order),
    and ids equal wherever the plain distance lies farther than that from
    its neighbours'. ``repeats`` more launches must give the same bits.
    Then both timed beside the bound. Returns (ulps, ms, plain_ms, bound_ms,
    bound_by)."""
    from databend_tpu_torch.ops.flash_topk import (_flash_rerank_plain,
                                                   flash_rerank)
    b, d = q.shape
    s = 2 * k
    what = f"{what}: {metric} B={b} rows={x.shape[0]} D={d} k={k}"
    before = flash_rerank.launches
    gv, gi = flash_rerank(minima, q, x, k, metric, tile=tile, shortlist=s,
                          n_valid=n_valid)
    torch.cuda.synchronize()
    check(flash_rerank.launches == before + 1,
          f"{what}: flash_rerank did not launch its kernel once")
    # the plain top k + 1: its first k are its top k, the last a neighbour
    wv, wi = _flash_rerank_plain(minima, q, x, k + 1, metric, tile=tile,
                                 shortlist=s, n_valid=n_valid)
    nxt, wv, wi = wv[:, 1:], wv[:, :k].contiguous(), wi[:, :k].contiguous()
    if exact:
        check(torch.equal(gi, wi) and same_bits(gv, wv),
              f"{what}: kernel differs from the plain version")
        ulps = 0.0
    else:
        rows = x[torch.clamp_max(wi, x.shape[0] - 1)]
        mag = wv.abs() if metric == "l2" \
            else (rows * q[:, None, :]).abs().sum(-1)
        tol = RERANK_ULPS * f32_ulp(mag)
        off = (gv - wv).abs()
        ulps = (off / f32_ulp(mag)).max().item()
        check(bool((off <= tol).all()),
              f"{what}: values {ulps:.2f} ulps from the plain version's")
        prev = torch.cat([wv[:, :1] - 2 * tol[:, :1] - 1, wv[:, :-1]], 1)
        near = ((wv - prev).abs() <= tol) | ((nxt - wv).abs() <= tol)
        check(not bool(((gi != wi) & ~near).any()),
              f"{what}: an id differs where the plain distances do not tie")
    for i in range(repeats):
        av, ai = flash_rerank(minima, q, x, k, metric, tile=tile, shortlist=s,
                              n_valid=n_valid)
        check(torch.equal(ai, gi) and same_bits(av, gv),
              f"{what}: launch {i + 2} differs from the first")
    del gv, gi, wv, wi
    ms = cuda_ms(lambda: flash_rerank(minima, q, x, k, metric, tile=tile,
                                      shortlist=s, n_valid=n_valid))
    plain_ms = cuda_ms(lambda: _flash_rerank_plain(
        minima, q, x, k, metric, tile=tile, shortlist=s, n_valid=n_valid))
    from portbench.approx_bounds import rerank_bound
    bound_s, bound_by = rerank_bound(b, minima.shape[0] * tile, d, tile,
                                     minima.shape[2], s, k)
    bound_ms = bound_s * 1e3
    how = "bit-equal" if exact else f"{ulps:.2f} ulps"
    print(f"[rerank] flash_rerank {what}: {how}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.0f}% reached) "
          f"[{card}]")
    return ulps, ms, plain_ms, bound_ms, bound_by


def rerank_case(g, x, b, metric, top=None, near=None, tile=16384):
    """(minima, q) of the flash route on the corpus ``x`` (its real rows,
    f32 on the card): the bf16 copy padded to whole tiles and D % 16 == 0
    as the server pads it, B queries at rows of ``x`` (``near``, else drawn)
    moved by whole numbers in [-3, 3] clamped to [0, ``top``], or by
    0.1 * N(0, 1) where ``top`` is None, and the kernel's group minima."""
    from databend_tpu_torch.ops.flash_topk import flash_scan, pad_for_flash
    n, d = x.shape
    xb = x.to(torch.bfloat16)
    if d % 16:
        xb = torch.nn.functional.pad(xb, (0, 16 - d % 16))
    norms = (x * x).sum(1) if metric == "l2" \
        else torch.zeros(n, device="cuda")
    xb, nb, _ = pad_for_flash(xb, norms, tile)
    if near is None:
        near = torch.randint(0, n, (b,), generator=g, device="cuda")
    if top is None:
        q = x[near] + 0.1 * torch.randn(b, d, generator=g, device="cuda")
    else:
        q = (x[near] + torch.randint(-3, 4, (b, d), generator=g,
                                     device="cuda")).clamp_(0, top)
    q = q.contiguous()
    return flash_scan(q, xb.contiguous(), nb.contiguous(), metric,
                      tile=tile), q


def whole_rows(g, n, d, top):
    return torch.randint(0, top + 1, (n, d), generator=g, device="cuda",
                         dtype=torch.int32).float()


def phase_rerank_kernel(card):
    """flash_rerank against its plain version at the serving chunk and at
    the shapes it must take (see the module doc, phase 3)."""
    from databend_tpu_torch.ops.flash_topk import flash_rerank
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    results = {}
    # the serving chunk: B = 256 against 1M x 128 whole-number rows, k = 10,
    # n_valid inside the last tile; query 0 at the last real row, which
    # must be served once
    x = whole_rows(g, N_ROWS, DIM, 255)
    for metric in ("l2", "ip"):
        near = torch.randint(0, N_ROWS, (256,), generator=g, device="cuda")
        near[0] = N_ROWS - 1
        minima, q = rerank_case(g, x, 256, metric, top=255, near=near)
        results[(metric, 256, DIM)] = hold_flash_rerank(
            card, "serving chunk", minima, q, x, K, metric, n_valid=N_ROWS,
            repeats=50 if metric == "l2" else 0)
        if metric == "l2":
            _, ids = flash_rerank(minima, q, x, K, metric, shortlist=2 * K,
                                  n_valid=N_ROWS)
            ids = ids.cpu()
            check(int(ids[0, 0]) == N_ROWS - 1 and all(
                len(set(r)) == K for r in ids.tolist()),
                "the last real row is not served once")
    del x
    # float rows, l2 and ip
    x = torch.randn(N_ROWS, DIM, generator=g, device="cuda")
    for metric in ("l2", "ip"):
        minima, q = rerank_case(g, x, 256, metric)
        results[(metric, 256, DIM, "float")] = hold_flash_rerank(
            card, "float rows", minima, q, x, K, metric, n_valid=N_ROWS,
            exact=False)
    del x, minima, q
    torch.cuda.empty_cache()
    # ties: rows of 16 values in {0, 1} tie by the thousand, in the group
    # minima (the shortlist by lowest group) and in the re-rank (by
    # shortlist position)
    x = whole_rows(g, CLUSTER_ROWS, 16, 1)
    for metric in ("l2", "ip"):
        minima, q = rerank_case(g, x, 256, metric, top=1)
        results[(metric, 256, 16, "ties")] = hold_flash_rerank(
            card, "tied rows", minima, q, x, K, metric, n_valid=CLUSTER_ROWS)
    # wide rows (D = 960: values in [0, 15] keep every f32 sum exact), a D
    # that is not a multiple of 4 (scalar loads), a corpus of one tile and
    # a larger k
    for what, n, d, top, k in (("D 960", CLUSTER_ROWS, 960, 15, K),
                               ("D 130", CLUSTER_ROWS, 130, 255, K),
                               ("one tile", 10_000, DIM, 255, K),
                               ("k 100", CLUSTER_ROWS, DIM, 255, 100)):
        x = whole_rows(g, n, d, top)
        minima, q = rerank_case(g, x, 256, "l2", top=top)
        results[(what,)] = hold_flash_rerank(card, what, minima, q, x, k,
                                             "l2", n_valid=n)
        del x, minima, q
    torch.cuda.empty_cache()
    return results


def impact_operands(g, n_pad, n_docs, slots, b, m, and_mode, dim=0,
                    n_real=None, group_terms=1):
    """A block's doc-major layout and a packed query batch, on the card, in
    the scorer's contract: a term at most once per doc (an arithmetic
    progression modulo a prime vocabulary), docs of L/4 to L/2 terms, pad
    docs and pad slots -2; queries of ``n_real`` (m/2 unless given) terms
    in groups of ``group_terms``, then pad terms (-1), packed by
    ``pack_query_terms``.
    With ``dim`` a [b, n_pad] cosine-style distance term as well."""
    vocab = {8: 17, 64: 131, 512: 1031}[slots]
    dev = "cuda"

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    ar = torch.arange(slots, device=dev, dtype=torch.int32)[None, :]
    term_ids = (rint(0, vocab, (n_pad, 1)) + ar * rint(1, vocab, (n_pad, 1))) \
        % vocab
    real = ar < rint(slots // 4, slots // 2 + 1, (n_pad, 1))
    real &= torch.arange(n_pad, device=dev)[:, None] < n_docs
    term_ids = torch.where(real, term_ids, -2)
    sat = torch.where(real, 0.5 + 1.5 * torch.rand(
        (n_pad, slots), generator=g, device=dev), 0.0)
    live = torch.arange(m, device=dev)[None, :].expand(b, m) < (
        m // 2 if n_real is None else n_real)
    qterms = torch.where(live, rint(0, vocab, (b, m)), -1)
    idf = torch.where(live, 0.5 + 2.5 * torch.rand(
        (b, m), generator=g, device=dev), 0.0)
    qgroup = torch.where(live, torch.arange(
        m, device=dev, dtype=torch.int32)[None, :].expand(b, m) // group_terms,
        -1)
    need = torch.full((b,), float(m // 2 if and_mode else 1), device=dev)
    dist = None
    if dim:
        emb = torch.nn.functional.normalize(torch.randn(
            n_pad, dim, generator=g, device=dev), dim=1)
        q = torch.nn.functional.normalize(torch.randn(
            b, dim, generator=g, device=dev), dim=1)
        dist = 1.0 - q @ emb.T
    from databend_tpu_torch.ops.impact_bm25 import pack_query_terms
    return (term_ids.contiguous(), sat,
            pack_query_terms(qterms, idf, qgroup), need), dist


def impact_bound(ops, dist, out_bytes=None):
    """(ms, "bytes" or "operations"): the least time of the function's
    work, whatever design runs it: one read of the layout, the query
    operands and the distance term plus one write of the output at the
    memory rate, or the operations of this run's data at their peak,
    whichever is larger. Of ``sat`` only the slots whose term some query
    asks for, what this data needs; one f32 product and one f64 sum (at
    the f64 rate) per (query, doc, real query term). The output is
    impact_bm25_scores' [b, n_pad]
    f32 scores (``out_bytes`` None) or impact_bm25_topk's [b, k] result
    (``out_bytes``), which adds one u64 key compare per (query, doc) at
    the int32 instruction rate."""
    term_ids, sat, qpack = ops[:3]
    n_pad = term_ids.shape[0]
    terms = qpack[..., 0]
    real_terms = int((terms >= 0).sum())
    nbytes = sum(t.numel() * t.element_size() for t in ops) \
        + (dist.numel() * 4 if dist is not None else 0)
    nbytes -= sat.numel() * 4 - 4 * int(
        torch.isin(term_ids, terms[terms >= 0]).sum())
    t_ops = real_terms * n_pad * (1 / F32_FLOPS_PER_S
                                  + 1 / F64_FLOPS_PER_S) * 1e3
    if out_bytes is None:
        out_bytes = qpack.shape[0] * n_pad * 4
    else:
        t_ops += qpack.shape[0] * n_pad / INT32_OPS_PER_S * 1e3
    nbytes += out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_impact_kernel(card, what, ops, dist, w_s=1.0, w_d=0.0, repeats=0):
    """One launch of impact_bm25_scores against its plain version on the
    same tensors (bit-equal; IMPACT_RTOL on finite scores and the same -inf
    pattern stated beside it), ``repeats`` more launches that must give the
    same bits, then both timed beside the bound; the plan printed.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    from databend_tpu_torch.ops.impact_bm25 import (
        _impact_bm25_scores_plain, _scores_plan, impact_bm25_scores,
        strip_subs)
    before = impact_bm25_scores.launches
    got = impact_bm25_scores(*ops, dist=dist, w_s=w_s, w_d=w_d)
    torch.cuda.synchronize()
    check(impact_bm25_scores.launches == before + 1, f"{what}: no launch")
    want = _impact_bm25_scores_plain(*ops, dist, w_s, w_d)
    check(same_bits(got, want), f"{what}: kernel not bit-equal to plain")
    for i in range(repeats):
        check(same_bits(impact_bm25_scores(*ops, dist=dist, w_s=w_s, w_d=w_d),
                        got), f"{what}: launch {i + 2} differs from the first")
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"{what}: -inf pattern differs")
    check(bool(fin.any()) and not bool(fin.all()),
          f"{what}: the shape needs both matched and unmatched docs")
    check(bool((got[~fin] == -torch.inf).all()), f"{what}: masked cells not -inf")
    err = (got[fin] - want[fin]).abs().max().item()
    rel = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)) \
        .max().item()
    check(rel <= IMPACT_RTOL, f"kernel vs plain {what}: rel err {rel}")
    share = fin.float().mean().item()
    del got, want, fin
    call = functools.partial(impact_bm25_scores, *ops, dist=dist, w_s=w_s,
                             w_d=w_d)
    ms, call_ms = device_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(
        lambda: _impact_bm25_scores_plain(*ops, dist, w_s, w_d), reps=2)
    bound_ms, bound_by = impact_bound(ops, dist)
    plan = _scores_plan(ops[0].shape[0], *ops[2].shape[:2])
    rows = int(ops[2][..., 3].max()) + 1   # the largest unit's vocabulary
    rep = f", {repeats} repeats equal" if repeats else ""
    print(f"[kernel] impact_bm25_scores {what}: bit-equal to the plain "
          f"version{rep}, max_abs_err {err} (max rel {rel}, "
          f"{100 * share:.1f}% of cells matched); plan {plan.units} unit(s) "
          f"of {plan.queries} queries, {plan.chunks} chunk(s) of "
          f"{plan.terms} terms, strips of {plan.subs} x 32 docs (of "
          f"{strip_subs(plan, rows)} x 32 for {rows} vocabulary rows), "
          f"{plan.qsplit} block(s) a unit's items; kernel {ms:.4f} ms "
          f"on the card ({call_ms:.4f} ms a call of the wrapper), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.0f}% reached) [{card}]")
    return err, ms, plain_ms, bound_ms, bound_by


def compare_select_ms(ops):
    """The count of the first selecting design's own work, for the record:
    one compare-select per (real doc slot, real query term) at the int32
    instruction rate (what that design did, not what the function needs)."""
    term_ids, _, qpack = ops[:3]
    return int((term_ids >= 0).sum()) * int((qpack[..., 0] >= 0).sum()) \
        / INT32_OPS_PER_S * 1e3


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def hold_impact_topk(card, what, ops, dist, w_s=1.0, w_d=0.0, repeats=0,
                     timed=True):
    """impact_bm25_topk against its plain version on the same tensors at
    k = 1, 10 and MAX_K: ids equal and values bit-equal. At k = 10 the
    kernel, the plain version and the pair it replaces (impact_bm25_scores,
    then the tie-rule top-k) are timed beside the bound; ``repeats`` more
    launches must give the first answer's bits.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by, pair_ms)."""
    from databend_tpu_torch.ops.impact_bm25 import (
        MAX_K, _impact_bm25_topk_plain, _topk_plan, impact_bm25_scores,
        impact_bm25_topk)
    from databend_tpu_torch.ops.topk import topk_largest_lowest_index
    b = ops[2].shape[0]
    for k in (1, K, MAX_K):
        before = impact_bm25_topk.launches
        vals, ids = impact_bm25_topk(*ops, k, dist, w_s, w_d)
        torch.cuda.synchronize()
        check(impact_bm25_topk.launches == before + 1,
              f"topk {what} k={k}: no launch")
        want_v, want_i = _impact_bm25_topk_plain(*ops, k, dist, w_s, w_d)
        check(vals.shape == (b, k) and torch.equal(ids, want_i),
              f"topk {what} k={k}: ids differ from the plain version")
        check(same_bits(vals, want_v),
              f"topk {what} k={k}: values differ from the plain version")
        if k == K:
            first = (vals, ids)
        del vals, ids, want_v, want_i
    for _ in range(repeats):
        vals, ids = impact_bm25_topk(*ops, K, dist, w_s, w_d)
        check(torch.equal(ids, first[1]) and same_bits(vals, first[0]),
              f"topk {what}: a repeated launch differs")
    matched = torch.isfinite(first[0]).float().mean().item()
    del first
    if not timed:
        print(f"[kernel] impact_bm25_topk {what}: ids and values bit-equal "
              f"to the plain version at k = 1, {K}, {MAX_K} "
              f"({100 * matched:.1f}% of the top {K} matched) [{card}]")
        return None
    call = functools.partial(impact_bm25_topk, *ops, K, dist, w_s, w_d)
    ms, call_ms = device_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(
        lambda: _impact_bm25_topk_plain(*ops, K, dist, w_s, w_d), reps=2)
    pair_ms = cuda_ms(lambda: topk_largest_lowest_index(
        impact_bm25_scores(*ops, dist=dist, w_s=w_s, w_d=w_d), K))
    bound_ms, bound_by = impact_bound(ops, dist, out_bytes=b * K * 12)
    p = _topk_plan(ops[0].shape[0], b, ops[2].shape[1], K,
                   torch.cuda.get_device_properties(0).multi_processor_count)
    rep = f", {repeats} repeats equal" if repeats else ""
    print(f"[kernel] impact_bm25_topk {what}: ids and values bit-equal to the "
          f"plain version at k = 1, {K}, {MAX_K}{rep} ({100 * matched:.1f}% "
          f"of the top {K} matched); k = {K}: plan {p.units} unit(s) of "
          f"{p.queries} queries, {p.chunks} chunk(s) of {p.terms} terms, "
          f"{p.qsplit} block(s) of {p.group} queries a unit, {p.ways} way(s) "
          f"a query, strips of {p.subs} x 32 docs, {p.blocks} blocks a unit "
          f"and group; kernel {ms:.4f} ms on the card "
          f"({call_ms:.4f} ms a call of the wrapper), plain "
          f"{plain_ms:.4f} ms, the scores kernel + tie-rule top-k {pair_ms:.4f}"
          f" ms, bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.0f}"
          f"% reached; the first design's compare-select count "
          f"{compare_select_ms(ops):.4f}"
          f" ms) [{card}]")
    return 0.0, ms, plain_ms, bound_ms, bound_by, pair_ms


def phase_impact_kernels(card):
    """Both entry points of csrc/impact_bm25_scores.cu at nine shapes and
    on a block where every doc ties; the scores entry point also on batches
    of more than one unit, the selecting one on AND queries with groups no
    doc can match.
    Returns ({shape: scores result}, {shape: topk result})."""
    from databend_tpu_torch.ops.impact_bm25 import (
        impact_bm25_scores, impact_bm25_topk, pack_query_terms)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = BLOCK_ROWS
    results, topk = {}, {}
    # (name, n_docs, L, b, m, AND?, fused metric or None)
    shapes = [("OR", n, 8, 128, 4, False, None),
              ("AND", n, 8, 128, 4, True, None),
              ("fused cosine", n, 8, 128, 4, False, "cosine"),
              ("fused l2", n, 8, 128, 4, False, "l2"),
              ("OR", n, 8, 8, 4, False, None),
              ("OR", n, 64, 128, 8, False, None),
              ("AND", n, 512, 8, 4, True, None),
              ("OR", n, 8, 1, 4, False, None),
              ("OR ragged", n - 1000, 8, 128, 4, False, None)]
    for name, n_docs, slots, b, m, and_mode, metric in shapes:
        ops, dist = impact_operands(g, n, n_docs, slots, b, m, and_mode,
                                    DIM if metric else 0)
        w_s, w_d = 1.0, 0.0
        if metric == "cosine":
            w_s, w_d = 0.04, -1.0
        elif metric == "l2":          # an ASC order: both weights negated
            dist = torch.sqrt(2.0 * dist.clamp_min(0.0))
            w_s, w_d = -0.04, 1.0
        what = f"{name} n_pad={n} n_docs={n_docs} L={slots} b={b} m={m}"
        results[(name, slots, b, m)] = hold_impact_kernel(
            card, what, ops, dist, w_s, w_d,
            repeats=300 if (name, slots) == ("OR", 8) and b in (8, 128)
            else 0)
        # the serving shape once more, 300 times over
        topk[(name, slots, b, m)] = hold_impact_topk(
            card, what, ops, dist, w_s, w_d,
            repeats=300 if (name, slots, b) == ("OR", 8, 128) else 0)
        del ops, dist
        torch.cuda.empty_cache()
    # vocabularies of more than one unit: four units of 32 queries whose 8
    # real terms form groups of two; two units of 8 queries whose 100 real
    # terms run over two chunks of 64
    for name, n_docs, slots, b, m, n_real, group_terms in (
            ("OR units, groups of two terms", n, 8, 128, 16, None, 2),
            ("OR chunks", n - 1000, 64, 16, 128, 100, 1)):
        ops, _ = impact_operands(g, n, n_docs, slots, b, m, False,
                                 n_real=n_real, group_terms=group_terms)
        hold_impact_kernel(card, f"{name} n_pad={n} n_docs={n_docs} L={slots}"
                                 f" b={b} m={m}", ops, None)
        del ops
    # an odd n_pad: rows of out and dist not 16-byte aligned
    ops, dist = impact_operands(g, n - 1, n - 1, 8, 128, 4, False, DIM)
    hold_impact_kernel(card, f"fused cosine n_pad={n - 1} L=8 b=128 m=4",
                       ops, dist, 0.04, -1.0)
    del ops, dist
    # every doc the same terms and saturations: one score class of 262,144
    ops, _ = impact_operands(g, n, n, 8, 128, 4, False)
    term_ids, sat, qpack, need = ops
    term_ids = term_ids[:1].expand(n, -1).contiguous()
    sat = sat[:1].expand(n, -1).contiguous()
    qterms = qpack[..., 0].clone()
    qterms[::2, 0] = term_ids[0, 0]
    qpack = pack_query_terms(qterms, qpack[..., 1].view(torch.float32),
                             qpack[..., 2])
    what = f"every doc ties n_pad={n} L=8 b=128 m=4"
    hold_impact_kernel(card, what, (term_ids, sat, qpack, need), None)
    tied = impact_bm25_scores(term_ids, sat, qpack, need)
    check(same_bits(tied, tied[:, :1].expand(-1, n)),
          f"{what}: docs with equal rows got different scores")
    del tied
    hold_impact_topk(card, what, (term_ids, sat, qpack, need), None,
                     timed=False)
    # docs whose (idf, saturation) products are one set at other query
    # positions, {1, 3e-8, 3e-8}, and every fourth doc empty: every score 1
    # + 2^-23 (an f32 sum in term order gives a third of them 1), the top k
    # the lowest matched rows
    kind = (torch.arange(n, device="cuda") % 4)[:, None]
    term_ids = torch.full((n, 8), -2, dtype=torch.int32, device="cuda")
    sat = torch.zeros((n, 8), device="cuda")
    a_docs, b_docs = kind % 2 == 0, kind == 1
    term_ids[:, :3] = torch.where(
        a_docs, torch.tensor([10, 11, 12], dtype=torch.int32, device="cuda"),
        torch.where(b_docs, torch.tensor([13, 14, 15], dtype=torch.int32,
                                         device="cuda"), -2))
    sat[:, :3] = torch.where(
        a_docs, torch.tensor([0.5, 3e-8, 3e-8], device="cuda"),
        torch.where(b_docs, torch.tensor([3e-8, 3e-8, 4.0], device="cuda"),
                    0.0))
    b = 8
    qterms = torch.tensor([[10, 11, 12, 13, 14, 15, -1, -1]], dtype=torch.int32,
                          device="cuda").expand(b, -1).contiguous()
    idf = torch.tensor([[2.0, 1.0, 1.0, 1.0, 1.0, 0.25, 0.0, 0.0]],
                       device="cuda").expand(b, -1).contiguous()
    qgroup = torch.where(qterms >= 0, torch.arange(
        8, dtype=torch.int32, device="cuda"), -1)
    ops = (term_ids, sat, pack_query_terms(qterms, idf, qgroup),
           torch.ones(b, device="cuda"))
    what = f"equal product sets at other query positions n_pad={n} L=8 b={b}"
    want = torch.where(kind[:, 0] == 3, -torch.inf, 1.0 + 2.0 ** -23)
    check(same_bits(impact_bm25_scores(*ops), want.expand(b, n)),
          f"{what}: a doc's score depends on its query positions")
    hold_impact_kernel(card, what, ops, None)
    hold_impact_topk(card, what, ops, None, timed=False)
    rows = torch.nonzero(kind[:, 0] != 3)[:K, 0]
    check(torch.equal(impact_bm25_topk(*ops, K)[1], rows.expand(b, -1)),
          f"{what}: top k not the lowest matched rows")
    del want, kind, a_docs, b_docs
    # AND with more groups than a query has terms: no doc of those matches
    ops, _ = impact_operands(g, n, n, 8, 128, 4, True)
    need = ops[3].clone()
    need[::2] = 4.0
    hold_impact_topk(card, f"AND, unmatched groups in half the queries "
                           f"n_pad={n} L=8 b=128 m=4",
                     (*ops[:3], need), None, timed=False)
    del ops, term_ids, sat, qpack, need
    torch.cuda.empty_cache()
    return results, topk


# --diagnose: text patches of csrc/flash_group_minima.cu, each (old, new)
# occurring once. The first two are timing only: they compute wrong minima.
DIAGNOSE_VARIANTS = {
    "loads + fold, no wgmma": [
        ("wgmma_m64n128k16(acc, qa[4 * kb + k], db + 2 * k, (kb | k) != 0);",
         "if (B < 0) wgmma_m64n128k16(acc, qa[4 * kb + k], db + 2 * k, "
         "(kb | k) != 0);"),
        ("float acc[64], run[64];", "float acc[64] = {}, run[64];")],
    "loads + wgmma, no fold": [
        ("for (int j = 0; j < 16; ++j) {\n"
         "          run[4 * j + 0] = fminf(",
         "for (int j = 0; j < 1; ++j) {\n"
         "          run[4 * j + 0] = fminf(")],
    # right but for a race: the stage's release may overtake the norms' loads
    "no fence before the release": [
        ("        __threadfence_block();\n", "")],
}
RACE_LAUNCHES = 2000


def diagnose_flash(card):
    """Time the kernel beside its source variants at D = 128 on the 1M-row
    corpus, in turns on this card: B = 128 (one query block a tile: every
    tile comes from device memory), 256 and 1024. Then count, for the kernel
    and for the variant without the fence, the launches at tile = 128 that
    leave the plain version's answer (the kernel: none)."""
    import ctypes
    from databend_tpu_torch.ops import _cuda, flash_topk as ft
    with open(os.path.join(_cuda.CSRC_DIR, "flash_group_minima.cu")) as f:
        source = f.read()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(N_ROWS, DIM, generator=g, device="cuda")
    xb, nb, _ = ft.pad_for_flash(x.to(torch.bfloat16), (x * x).sum(1), 16384)
    del x
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": ft._launcher()}
        for i, (name, patches) in enumerate(DIAGNOSE_VARIANTS.items()):
            text = source
            for old, new in patches:
                check(text.count(old) == 1, f"--diagnose: {old!r} not once")
                text = text.replace(old, new)
            src = os.path.join(tmp, f"variant{i}.cu")
            with open(src, "w") as f:
                f.write(text)
            subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                            src[:-3] + ".so", src], check=True,
                           capture_output=True, timeout=300)
            libs[name] = ctypes.CDLL(src[:-3] + ".so")
            libs[name].flash_group_minima_launch.argtypes = ft._LAUNCH_ARGTYPES
        stream = torch.cuda.current_stream().cuda_stream
        for b in (128, 256, 1024):
            qn = torch.randn(b, DIM, generator=g, device="cuda").bfloat16()
            out = torch.empty((xb.shape[0] // 16384, b, 128), device="cuda")

            def launch(lib):
                err = lib.flash_group_minima_launch(
                    qn.data_ptr(), xb.data_ptr(), nb.data_ptr(),
                    out.data_ptr(), b, xb.shape[0], DIM, 16384, stream)
                check(err == 0, f"--diagnose: launch failed ({err})")

            for turn in range(2):
                times = ", ".join(
                    f"{name} {cuda_ms(lambda: launch(lib), 10):.4f} ms"
                    for name, lib in libs.items())
                print(f"[diagnose] l2 B={b} N={xb.shape[0]} D={DIM} turn "
                      f"{turn}: {times} [{card}]")

        # the race the fence closes: one step per tile, 6,123 work items a
        # launch; count the launches that leave the plain version's answer
        del xb, nb
        x = torch.randn(CLUSTER_ROWS - 1000, DIM, generator=g, device="cuda")
        xb, nb, _ = ft.pad_for_flash(x.to(torch.bfloat16), (x * x).sum(1), 128)
        q = torch.randn(300, DIM, generator=g, device="cuda")
        want = ft._flash_group_minima_plain(q, xb, nb, "l2", tile=128)
        fin = torch.isfinite(want)
        tol = FLASH_TOL * want[fin].abs().max().item()
        qn = (q * -2.0).to(torch.bfloat16)
        out = torch.empty_like(want)
        for name in ("kernel", "no fence before the release"):
            bad = 0
            for _ in range(RACE_LAUNCHES):
                err = libs[name].flash_group_minima_launch(
                    qn.data_ptr(), xb.data_ptr(), nb.data_ptr(),
                    out.data_ptr(), 300, xb.shape[0], DIM, 128, stream)
                check(err == 0, f"--diagnose: launch failed ({err})")
                bad += int((torch.where(fin, out - want, 0.0).abs().max()
                            > tol).item())
            print(f"[diagnose] l2 B=300 N={xb.shape[0]} D={DIM} tile=128, "
                  f"{name}: {bad} of {RACE_LAUNCHES} launches differ from "
                  f"the plain version [{card}]")
            check(name != "kernel" or bad == 0, "the kernel races")


EXACT_REPEATS = 300    # [exact]: launches at the serving shape that must repeat
EXACT_HNSW_REPEATS = 100   # [exact]: the same at the HNSW build's batch
EXACT_HNSW_KS = (1, 2, 10, 31, 32, 33, 64, 96, 97, 101, 127, 128)


def exact_bound(qx, qq, xx, keep, k):
    """(ms, "bytes" or "operations"): the least time one exact_topk_select
    call could take: one read of the product block, the norms and the mask
    and one write of the [b, k] result at the memory rate, or its f32
    operations (at most five a cell: the l2 epilogue) at the f32 peak and
    one key compare a cell at the int32 rate, whichever is larger."""
    b, n = qx.shape
    nbytes = qx.numel() * 4 + b * k * 12 + sum(
        t.numel() * t.element_size() for t in (qq, xx, keep) if t is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * n * (5 / F32_FLOPS_PER_S + 1 / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact_plan(b, n):
    """The plan exact_topk_select takes at (b, n) on this card."""
    from databend_tpu_torch.ops import exact_topk as ex
    return ex._plan(b, n, torch.cuda.get_device_properties(0)
                    .multi_processor_count)


def hold_exact(card, what, qx, qq, xx, metric, k, n_valid=None, keep=None,
               repeats=0, timed=False, floor=False):
    """exact_topk_select against its plain version on the same tensors: ids
    equal and values bit-equal (one launch, or none above MAX_K, where the
    composition runs); ``repeats`` more launches must give the first
    answer's bits. ``timed``: the kernel (a CUDA graph replay, and a
    wrapper call), the plain version and ``torch.topk`` over the finished
    distance block (no tie rule, no masks: the library yardstick) beside
    the bound;
    ``floor``: an empty kernel's graph replay too, the least a launch
    takes. Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    topk_ms)."""
    from databend_tpu_torch.ops import exact_topk as ex
    from databend_tpu_torch.ops.distance import finish_distance
    call = functools.partial(ex.exact_topk_select, qx, qq, xx, metric, k,
                             n_valid, keep)
    before = ex.exact_topk_select.launches
    vals, ids = call()
    torch.cuda.synchronize()
    want = 1 if k <= ex.MAX_K else 0
    check(ex.exact_topk_select.launches == before + want,
          f"[exact] {what}: {ex.exact_topk_select.launches - before} "
          f"launches, want {want}")
    want_v, want_i = ex._exact_topk_select_plain(qx, qq, xx, metric, k,
                                                 n_valid, keep)
    check(vals.shape == (qx.shape[0], k) and torch.equal(ids, want_i),
          f"[exact] {what}: ids differ from the plain version")
    check(same_bits(vals, want_v),
          f"[exact] {what}: values differ from the plain version")
    fin = torch.isfinite(want_v)
    err = float((vals[fin] - want_v[fin]).abs().max()) if fin.any() else 0.0
    for i in range(repeats):
        again_v, again_i = call()
        check(torch.equal(again_i, ids) and same_bits(again_v, vals),
              f"[exact] {what}: launch {i + 2} differs from the first")
    inf_share = 1.0 - float(fin.float().mean())
    del want_v, want_i, fin
    rep = f", {repeats} repeats equal" if repeats else ""
    if k <= ex.MAX_K:
        plan = exact_plan(*qx.shape)
        on = f"{plan.ways} segment(s) of {plan.span} a query"
    else:
        on = "the composition"
    if not timed:
        print(f"[exact] exact_topk_select {what}: ids and values bit-equal to "
              f"the plain version{rep} ({100 * inf_share:.1f}% of the top {k} "
              f"+inf; plan: {on}) [{card}]")
        return err, None, None, None, None, None
    ms, call_ms = device_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(lambda: ex._exact_topk_select_plain(
        qx, qq, xx, metric, k, n_valid, keep), reps=3)
    d = finish_distance(qx, qq, xx, metric)
    topk_ms = device_ms(lambda: torch.topk(d, k, dim=1, largest=False))
    del d
    bound_ms, bound_by = exact_bound(qx, qq, xx, keep, k)
    floor_txt = ""
    if floor:
        lib = ex._launcher()
        floor_ms = device_ms(lambda: lib.exact_topk_select_empty(
            torch.cuda.current_stream().cuda_stream))
        floor_txt = (f", launch floor {floor_ms:.4f} ms (an empty kernel's "
                     "graph replay)")
    print(f"[exact] exact_topk_select {what}: ids and values bit-equal to the "
          f"plain version{rep}; plan: {on}; kernel {ms:.4f} ms on the card "
          f"({call_ms:.4f} ms a wrapper call); bound {bound_ms:.4f} ms "
          f"({bound_by}, {100 * bound_ms / ms:.0f}% reached){floor_txt}; plain "
          f"{plain_ms:.4f} ms; torch.topk over "
          f"the finished distances {topk_ms:.4f} ms [{card}]")
    return err, ms, plain_ms, bound_ms, bound_by, topk_ms


def phase_exact_kernel(card):
    """exact_topk_select against its plain version on the card, on the
    product blocks of the exact paths: the
    serving chunk (b = 256 against 1,000,000 SIFT-valued rows of 128) under
    l2, cosine and ip, each EXACT_REPEATS times over, and at k = 1, 128 and
    129 (the composition's route), with a mask per query, with one row of
    mask for every query, with n_valid < N and on a ragged, unaligned N;
    one query (b = 1); the [ties] blocks (integer rows in [0, 3], and rows
    of a power-of-two norm under cosine with a zero query); [mesh]'s chunk
    (b = 8 against 131,072 rows of 96) beside the launch floor; the HNSW
    build's batch (b = 1,024 against 65,536 rows, a bf16 product) at every k
    of EXACT_HNSW_KS, k = 101 EXACT_HNSW_REPEATS times over, with a mask a
    query and n_valid < N, and on tied integer rows in [0, 3] (ties across
    the 101st place). Returns {shape: hold_exact's tuple}."""
    from databend_tpu_torch.ops.distance import normalize, pairwise_product
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    x = torch.randint(0, 256, (N_ROWS, DIM), generator=g, device="cuda",
                      dtype=torch.int32).float()
    q = x[torch.randint(0, N_ROWS, (256,), generator=g, device="cuda")] \
        + torch.randn(256, DIM, generator=g, device="cuda")
    norms = (x * x).sum(1)
    for metric in ("l2", "cosine", "ip"):
        xm = normalize(x) if metric == "cosine" else x
        ops = pairwise_product(q, xm, metric, x_sq_norms=norms,
                               x_normalized=metric == "cosine")
        out[(metric, 256, K)] = hold_exact(
            card, f"{metric} b=256 N={N_ROWS} k={K}", *ops, metric, K,
            repeats=EXACT_REPEATS, timed=True)
        if metric != "l2":
            del ops, xm
            continue
        for k in (1, 128, 129):
            out[(metric, 256, k)] = hold_exact(
                card, f"l2 b=256 N={N_ROWS} k={k}", *ops, metric, k,
                timed=k == 128)
        keep = torch.rand(256, N_ROWS, generator=g, device="cuda") < 0.05
        out["keep"] = hold_exact(card, "l2 b=256, a mask a query (5% kept)",
                                 *ops, metric, K, keep=keep, timed=True)
        row = keep[:1].clone()
        out["keep row"] = hold_exact(card, "l2 b=256, one mask row", *ops,
                                     metric, K, keep=row)
        out["n_valid"] = hold_exact(card, f"l2 b=256, n_valid = {N_ROWS - 999}",
                                    *ops, metric, K, n_valid=N_ROWS - 999)
        del keep, row
        n = N_ROWS - 3               # rows of 4 * N - 12 bytes: scalar loads
        qx = ops[0][:, :n].contiguous()
        out["ragged"] = hold_exact(card, f"l2 b=256 N={n} (unaligned rows)",
                                   qx, ops[1], ops[2][:n].contiguous(),
                                   metric, K, n_valid=n - 5)
        out["b=1"] = hold_exact(card, f"l2 b=1 N={N_ROWS} k={K}",
                                ops[0][:1].contiguous(), ops[1][:1].clone(),
                                ops[2], metric, K)
        del qx, ops, xm
    del x, q, norms
    torch.cuda.empty_cache()

    # the [ties] blocks: exact distances, ties at every rank
    xt = torch.randint(0, 4, (TIES_ROWS, DIM), generator=g,
                       device="cuda").float()
    qt = torch.randint(0, 4, (300, DIM), generator=g, device="cuda").float()
    out["ties l2"] = hold_exact(card, f"[ties] l2 b=256 N={TIES_ROWS}",
                                *pairwise_product(qt[:256], xt, "l2"), "l2",
                                K)
    pool = torch.randint(0, 4, (400_000, 8), generator=g,
                         device="cuda").float()
    pool = pool[torch.isin((pool ** 2).sum(1),
                           torch.tensor([1.0, 4.0, 16.0], device="cuda"))]
    xc = pool[torch.randint(0, pool.shape[0], (TIES_ROWS,), generator=g,
                            device="cuda")]
    qc = pool[:256].clone()
    qc[0] = 0.0
    out["ties cosine"] = hold_exact(
        card, f"[ties] cosine b=256 N={TIES_ROWS}, a zero query",
        *pairwise_product(qc, normalize(xc), "cosine", x_normalized=True),
        "cosine", K)
    del xt, qt, pool, xc, qc

    # [mesh]'s chunk and the HNSW build's batch
    xm = torch.randn(131_072, MESH_DIM, generator=g, device="cuda")
    qm = torch.randn(MESH_B, MESH_DIM, generator=g, device="cuda")
    out["mesh"] = hold_exact(card, f"l2 b={MESH_B} N=131072 D={MESH_DIM}",
                             *pairwise_product(qm, xm, "l2"), "l2", K,
                             timed=True, floor=True)
    del xm, qm
    xh = normalize(torch.randn(65_536, DIM, generator=g, device="cuda"))
    ops = pairwise_product(xh[:1024], xh, "ip", torch.bfloat16)
    for k in EXACT_HNSW_KS:
        hnsw = k == 101
        out[("hnsw", k)] = hold_exact(
            card, f"ip b=1024 N=65536 k={k}, bf16 product", *ops, "ip", k,
            repeats=EXACT_HNSW_REPEATS if hnsw else 0, timed=hnsw)
    out["hnsw"] = out[("hnsw", 101)]
    keep = torch.rand(1024, 65_536, generator=g, device="cuda") < 0.05
    out["hnsw keep"] = hold_exact(
        card, "ip b=1024 N=65536 k=101, a mask a query (5% kept)", *ops,
        "ip", 101, keep=keep)
    out["hnsw n_valid"] = hold_exact(
        card, "ip b=1024 N=65536 k=101, n_valid = 60,000", *ops, "ip", 101,
        n_valid=60_000)
    del ops, keep, xh
    xi = torch.randint(0, 4, (65_536, DIM), generator=g,
                       device="cuda").float()
    out["hnsw ties"] = hold_exact(
        card, "l2 b=1024 N=65536 k=101, integer rows in [0, 3]",
        *pairwise_product(xi[:1024], xi, "l2"), "l2", 101,
        repeats=EXACT_HNSW_REPEATS)
    del xi
    torch.cuda.empty_cache()
    return out


def exact_shapes(g):
    """The four shapes of exact_topk_select's redesign, one at a time:
    (name, metric, k, (qx, qq, xx)): the serving chunk at k = 10 and 128
    (b = 256 against 1M SIFT-valued rows of 128, l2), the HNSW build's
    batch (b = 1,024 against 65,536 unit rows, ip, bf16 product, k = 101)
    and [mesh]'s chunk (b = 8 against 131,072 rows of 96, l2, k = 10)."""
    from databend_tpu_torch.ops.distance import normalize, pairwise_product
    x = torch.randint(0, 256, (N_ROWS, DIM), generator=g, device="cuda",
                      dtype=torch.int32).float()
    q = x[torch.randint(0, N_ROWS, (256,), generator=g, device="cuda")] \
        + torch.randn(256, DIM, generator=g, device="cuda")
    ops = pairwise_product(q, x, "l2")
    del x, q
    yield "serving l2 b=256 N=1M k=10", "l2", K, ops
    yield "serving l2 b=256 N=1M k=128", "l2", 128, ops
    del ops
    xh = normalize(torch.randn(65_536, DIM, generator=g, device="cuda"))
    yield "HNSW ip b=1024 N=65536 k=101 bf16", "ip", 101, \
        pairwise_product(xh[:1024], xh, "ip", torch.bfloat16)
    del xh
    xm = torch.randn(131_072, MESH_DIM, generator=g, device="cuda")
    qm = torch.randn(MESH_B, MESH_DIM, generator=g, device="cuda")
    yield f"[mesh] l2 b={MESH_B} N=131072 k={K}", "l2", K, \
        pairwise_product(qm, xm, "l2")


def exact_iterations(plan, n):
    """Warp iterations of one query under ``plan``: a block reads ROUND
    positions a round, STEP a warp."""
    from databend_tpu_torch.ops import exact_topk as ex
    return sum(-(-min(plan.span, n - lo) // ex.ROUND) * (ex.ROUND // ex.STEP)
               for lo in range(0, n, plan.span))


def diagnose_exact(card):
    """--diagnose: exact_topk_select at the four shapes of exact_shapes. A
    build of its source with -DEXACT_TOPK_DIAG counts, per launch, the warp
    iterations where some cell passed the coarse filter, the appends that
    took a key, the keys taken, the cuts, the radix passes, and the blocks
    whose threshold was still 0 at the end, beside their final thresholds'
    mean distance and the answer's k-th; the ids of that build must equal
    the kernel's. Then the call's two parts apart, as CUDA graph replays:
    the memset of the thresholds and tickets (that build's
    exact_topk_select_zero on the same scratch; none with one segment a
    query) and the kernel's launch, the whole call less the memset."""
    import ctypes
    from databend_tpu_torch.ops import _cuda, exact_topk as ex
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libexact_diag.so")
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DEXACT_TOPK_DIAG",
                        "-o", so, os.path.join(_cuda.CSRC_DIR,
                                               "exact_topk_select.cu")],
                       check=True, capture_output=True, timeout=300)
        diag = ex._bind(ctypes.CDLL(so))
        diag.exact_topk_select_diag.argtypes = [ctypes.c_void_p] * 2
        diag.exact_topk_select_zero.argtypes = [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        counts = (ctypes.c_ulonglong * 7)()
        thr_sum = ctypes.c_double()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        for name, metric, k, (qx, qq, xx) in exact_shapes(g):
            b, n = qx.shape
            args = (qx, qq, xx, metric, k, None, None)
            want_v, want_i = ex.exact_topk_select(*args)
            kth = float(want_v[:, -1].double().mean())
            plan = ex._plan(b, n, sms)
            check(diag.exact_topk_select_diag(counts, ctypes.byref(
                thr_sum)) == 0, "--diagnose: counters unreadable")
            _, ids = ex._launch(diag, *args, plan)
            torch.cuda.synchronize()
            check(diag.exact_topk_select_diag(counts, ctypes.byref(
                thr_sum)) == 0, "--diagnose: counters unreadable")
            check(torch.equal(ids, want_i), f"--diagnose: {name}: ids differ")
            c = list(counts)
            iters = b * exact_iterations(plan, n)
            items, cold = c[5], c[6]
            mean_thr = thr_sum.value / max(1, items - cold)
            print(f"[diagnose] exact_topk_select {name} ({plan.ways} x "
                  f"{plan.span} a query; {items} blocks): warp iterations "
                  f"with a candidate {c[0]} of {iters} "
                  f"({100 * c[0] / iters:.1f}%); appends that took a key "
                  f"{c[1]}; keys taken {c[2]} ({c[2] / b:.1f} a query, "
                  f"{c[2] / items:.1f} a block); cuts {c[3]} "
                  f"({c[3] / items:.2f} a block); radix passes {c[4]}; "
                  f"blocks ending at threshold 0: {cold}; their final "
                  f"thresholds' mean distance {mean_thr:.6g} against the "
                  f"answer's k-th {kth:.6g} [{card}]")
            call_ms = device_ms(lambda: ex._launch(ex._launcher(), *args,
                                                   plan))
            memset_ms = 0.0
            words = ex._scratch_words(plan, b, k)
            if words:
                part = torch.zeros(words, dtype=torch.int64, device="cuda")
                memset_ms = device_ms(lambda: check(
                    diag.exact_topk_select_zero(
                        part.data_ptr(), b, plan.ways, k,
                        torch.cuda.current_stream().cuda_stream) == 0,
                    "--diagnose: the memset failed"))
                del part
            print(f"[diagnose] exact_topk_select {name}: call {call_ms:.4f} "
                  f"ms, memset {memset_ms:.4f} ms, block kernel "
                  f"{call_ms - memset_ms:.4f} ms (the call less the memset) "
                  f"[{card}]")
            del qx, qq, xx, want_v, want_i
            torch.cuda.empty_cache()


def ties_truth(x, q, metric, keep=None):
    """The reference's ids on exact distances: ascending distance, equal
    distances by ascending row id (``jax.lax.top_k(-d, k)``); rows outside
    ``keep`` excluded. Integer rows give exact l2 distances, and rows of a
    power-of-two norm exact cosines."""
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        d = (x64 * x64).sum(1)[None, :] - 2.0 * (q64 @ x64.T) \
            + (q64 * q64).sum(1)[:, None]
    else:
        xn = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        qn = q64 / np.maximum(np.linalg.norm(q64, axis=1, keepdims=True), 1)
        d = 1.0 - qn @ xn.T
    if keep is not None:
        d = np.where(keep, d, np.inf)
    kth = np.partition(d, K - 1, axis=1)[:, K - 1]
    out = []
    for b in range(d.shape[0]):
        cand = np.nonzero(d[b] <= kth[b])[0]
        out.append(cand[np.argsort(d[b, cand], kind="stable")][:K])
    return np.stack(out), float(((d <= kth[:, None]).sum(1) > K).mean())


def phase_ties(card):
    """Exact KNN on tied distances takes the reference's order on the card
    (ROADMAP fault F7): integer rows in [0, 3] (TIES_ROWS x 128, l2) and
    rows of a power-of-two norm (TIES_ROWS x 8, cosine, and a zero query),
    whose distances are exact in f32, so every path's ids must equal the
    numpy tie-rule truth: 8 literal statements, execute_batch at B = 256,
    execute_batch_block at B = 300 (two query chunks) and a filtered batch
    (``price < ?``). Then ``topk_smallest_lowest_index`` on the card against
    itself on CPU tensors, on a tied block and on one without ties, with
    rows of 262,144 (one top-(k+1); without ties only reordered) and 8,192
    distances (one stable sort): ids equal, values bit-equal."""
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.ops import topk
    from databend_tpu_torch.ops.exact_topk import exact_topk_select
    from databend_tpu_torch.types import VectorType

    rng = np.random.default_rng(TIES_SEED)
    x = rng.integers(0, 4, (TIES_ROWS, DIM)).astype(np.float32)
    q = rng.integers(0, 4, (300, DIM)).astype(np.float32)
    pool = rng.integers(0, 4, (400_000, 8)).astype(np.float32)
    pool = pool[np.isin((pool ** 2).sum(1), (1, 4, 16))]
    xc = pool[rng.integers(0, len(pool), TIES_ROWS)]
    qc = pool[rng.integers(0, len(pool), 300)]
    qc[0] = 0.0
    price = rng.integers(0, 100, TIES_ROWS).astype(np.int64)
    bounds = np.resize(np.array([1, 50, 90, 100]), 300)
    total = 0
    with tempfile.TemporaryDirectory() as root:
        ctx = dt.SessionContext(root)
        try:
            for name, rows in (("ti", x), ("tc", xc)):
                d = rows.shape[1]
                ctx.sql(f"CREATE TABLE {name} (id BIGINT, price BIGINT, "
                        f"emb VECTOR({d})) ROW_PER_BLOCK='{TIES_ROWS}'")
                ctx.sql(f"CREATE VECTOR INDEX {name}v ON {name}(emb) "
                        "distance='l2,cosine'")
                ctx.insert_block(name, DataBlock(
                    ["id", "price", "emb"],
                    [Column.from_numpy(np.arange(TIES_ROWS, dtype=np.int64)),
                     Column.from_numpy(price),
                     Column.from_numpy(rows, VectorType(d))]))
            ctx.sql("SET vector_host_scan_max_rows = 0")
            for fn, table, rows, qs in (("l2_distance", "ti", x, q),
                                        ("cosine_distance", "tc", xc, qc)):
                metric = fn.split("_")[0]
                want, tied = ties_truth(rows, qs, metric)
                keep = price[None, :] < bounds[:, None]
                want_f, _ = ties_truth(rows, qs, metric, keep)
                lit = [",".join(f"{v:.1f}" for v in r) for r in qs[:8]]
                exact_topk_select.launches = 0
                got_lit = np.array([[r[0] for r in ctx.sql(
                    f"SELECT id FROM {table} ORDER BY {fn}(emb, [{v}]) "
                    "LIMIT 10").rows()] for v in lit])
                ps = ctx.prepare(f"SELECT id, {fn}(emb, ?) AS d FROM {table} "
                                 f"ORDER BY {fn}(emb, ?) LIMIT 10")
                got_b = np.array([[r[0] for r in res.rows()] for res in
                                  ps.execute_batch([(v, v) for v in qs[:256]],
                                                   exact=True)])
                got_blk = np.array([r[1] for r in ps.execute_batch_block(
                    [(v, v) for v in qs], exact=True).rows()]).reshape(-1, K)
                fps = ctx.prepare(f"SELECT id, {fn}(emb, ?) AS d FROM {table}"
                                  f" WHERE price < ? ORDER BY {fn}(emb, ?) "
                                  "LIMIT 10")
                got_f = np.array([[r[0] for r in res.rows()] for res in
                                  fps.execute_batch(
                                      [(v, int(p), v)
                                       for v, p in zip(qs, bounds)],
                                      exact=True)])
                launches = exact_topk_select.launches
                total += launches
                same = {"literal": (got_lit == want[:8]).all(1),
                        "execute_batch": (got_b == want[:256]).all(1),
                        "execute_batch_block": (got_blk == want).all(1),
                        "filtered": (got_f == want_f).all(1)}
                print(f"[ties] {fn}, {TIES_ROWS} x {rows.shape[1]} rows, "
                      f"{100 * tied:.0f}% of queries tie across rank 10: "
                      + ", ".join(f"{k} {int(v.sum())}/{len(v)} equal to "
                                  f"the tie-rule truth"
                                  for k, v in same.items())
                      + f"; exact_topk_select launches {launches} [{card}]")
                check(launches >= 8 + 1 + 2 + 2,
                      f"[ties] {fn}: exact_topk_select launched {launches} "
                      "times, want one a statement and a query chunk")
                for k, v in same.items():
                    check(v.all(), f"[ties] {fn} {k}: ids differ from the "
                                   "tie-rule truth")
        finally:
            ctx.close()
    g = torch.Generator(device="cuda").manual_seed(TIES_SEED)
    for n in (1 << 18, 1 << 13):       # the top-(k+1) way, the sort way
        for what, d in (
                ("tied", torch.randint(0, 40, (256, n), generator=g,
                                       device="cuda").float()),
                ("no ties", torch.randperm(n, generator=g, device="cuda")
                 .float()[None].expand(256, -1).contiguous())):
            gv, gi = topk.topk_smallest_lowest_index(d, K)
            cv, ci = topk.topk_smallest_lowest_index(d.cpu(), K)
            same = torch.equal(gi.cpu(), ci) and same_bits(gv.cpu(), cv)
            print(f"[ties] topk_smallest_lowest_index on a [256, {n}] "
                  f"block, {what}: card equal to CPU: {same} [{card}]")
            check(same, f"[ties] the card's selection ({what}, n = {n}) "
                        "differs from the CPU's")
    return total


def phase_main_path(card, profile):
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.ops import exact_topk as ex
    from databend_tpu_torch.ops import flash_topk as ft
    from databend_tpu_torch.types import VectorType

    rng = np.random.default_rng(SEED)
    centers = rng.integers(0, 256, size=(1000, DIM)).astype(np.float32)
    t0 = time.perf_counter()
    x = sift_like(rng, N_ROWS, centers)
    queries = sift_like(rng, 1024, centers)
    gt = {m: ground_truth(x, queries[:N_GT], m) for m in ("l2", "cosine")}
    print(f"[data] {N_ROWS} x {DIM} rows + ground truth in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    with tempfile.TemporaryDirectory() as root:
        ctx = dt.SessionContext(root)
        try:
            t0 = time.perf_counter()
            ctx.sql(f"CREATE TABLE t (id BIGINT, emb VECTOR({DIM})) "
                    "ROW_PER_BLOCK='262144'")
            ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2,cosine'")
            ctx.insert_block("t", DataBlock(
                ["id", "emb"],
                [Column.from_numpy(np.arange(N_ROWS, dtype=np.int64)),
                 Column.from_numpy(x, VectorType(DIM))]))
            print(f"[main] create + insert {N_ROWS} rows: "
                  f"{time.perf_counter() - t0:.1f} s")

            ft.flash_group_minima.launches = 0
            ft.flash_rerank.launches = 0
            ex.exact_topk_select.launches = 0
            run_queries(ctx, queries, gt, card, ft, ex)
            launches = ft.flash_group_minima.launches
            rerank_launches = ft.flash_rerank.launches
            exact_launches = ex.exact_topk_select.launches
            print(f"[main] launches over the main path: flash_group_minima "
                  f"{launches}, flash_rerank {rerank_launches}, "
                  f"exact_topk_select {exact_launches} [{card}]")
            check(rerank_launches == launches,
                  "the main path's flash chunks and re-rank launches differ")
            if profile:
                profile_modes(ctx, queries, card)
            return launches, exact_launches, x, queries, gt
        finally:
            ctx.close()


def _ids_scores(res, b):
    ids = np.asarray(res.block.column("id").numpy(), np.int64).reshape(b, K)
    d = np.asarray(res.block.column("d").numpy(), np.float32).reshape(b, K)
    return ids, d


def run_queries(ctx, queries, gt, card, ft, ex):
    d_l2, kth_l2 = gt["l2"]
    d_cos, kth_cos = gt["cosine"]

    lit = "[" + ",".join(str(int(v)) for v in queries[0]) + "]"
    t0 = time.perf_counter()
    before = ex.exact_topk_select.launches
    rows = ctx.sql(f"SELECT id FROM t ORDER BY l2_distance(emb, {lit}) "
                   "LIMIT 10").rows()
    lit_s = time.perf_counter() - t0
    grew = ex.exact_topk_select.launches - before
    r = recall(np.array([[i for (i,) in rows]]), d_l2[:1], kth_l2[:1])
    print(f"[main] literal ctx.sql KNN: {lit_s:.3f} s (first query, loads the "
          f"corpus), recall@10 {r}, exact_topk_select launches {grew} "
          f"[{card}]")
    check(grew > 0, "the literal KNN statement launched exact_topk_select "
                    "no time")
    check(len(rows) == K and r >= 0.99, f"literal KNN recall {r}")

    ps = ctx.prepare("SELECT id FROM t ORDER BY l2_distance(emb, ?) LIMIT 10")
    q256 = queries[:256]
    ps.execute_batch(q256)                                     # warm
    before = ex.exact_topk_select.launches
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = ps.execute_batch(q256)
        times.append(time.perf_counter() - t0)
    dt_b = float(np.median(times))
    ids = np.array([[i for (i,) in rr.rows()] for rr in res[:N_GT]])
    r = recall(ids, d_l2, kth_l2)
    grew = ex.exact_topk_select.launches - before
    print(f"[main] execute_batch l2 exact B=256: {256 / dt_b:.1f} QPS "
          f"(median of {REPS} batches, {[round(t * 1e3, 3) for t in times]} "
          f"ms), recall@10 {r}, exact_topk_select launches {grew} [{card}]")
    check(grew == REPS, f"execute_batch B=256: {grew} exact_topk_select "
                        f"launches over {REPS} batches, want one a batch")
    check(len(res) == 256 and r >= 0.99, f"execute_batch recall {r}")
    check(ps._knn._x.is_cuda, "the corpus is not on the card")

    sql = ("SELECT id, {fn}(emb, ?) AS d FROM t ORDER BY {fn}(emb, ?) LIMIT 10")
    sets = [(v, v) for v in queries]
    modes = [("l2", True, 0.99), ("l2", False, 0.95), ("cosine", False, 0.95)]
    for metric, exact, need in modes:
        bp = ctx.prepare(sql.format(fn=f"{metric}_distance"))
        bp.execute_batch_block(sets, exact=exact)              # warm
        before = ft.flash_group_minima.launches
        before_rr = ft.flash_rerank.launches
        before_ex = ex.exact_topk_select.launches
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            res = bp.execute_batch_block(sets, exact=exact)
            times.append(time.perf_counter() - t0)
        dt_b = float(np.median(times))
        grew = ft.flash_group_minima.launches - before
        grew_rr = ft.flash_rerank.launches - before_rr
        grew_ex = ex.exact_topk_select.launches - before_ex
        ids, d = _ids_scores(res, len(sets))
        check(np.isfinite(d).all(), f"{metric} exact={exact}: non-finite scores")
        dd, kth = (d_l2, kth_l2) if metric == "l2" else (d_cos, kth_cos)
        r = recall(ids[:N_GT], dd, kth)
        true = np.take_along_axis(dd, ids[:N_GT], 1)
        true = np.sqrt(np.maximum(true, 0)) if metric == "l2" else true
        err = float(np.abs(d[:N_GT] - true).max())
        print(f"[main] execute_batch_block {metric} exact={exact} B={len(sets)}: "
              f"{len(sets) / dt_b:.1f} QPS (median of {REPS} batches, "
              f"{[round(t * 1e3, 3) for t in times]} ms), recall@10 {r}, "
              f"max |score - f64| {err}, flash launches {grew}, "
              f"flash_rerank launches {grew_rr}, "
              f"exact_topk_select launches {grew_ex} [{card}]")
        check(r >= need, f"{metric} exact={exact}: recall {r} < {need}")
        check(err <= 1e-3 * max(1.0, float(np.abs(true).max())),
              f"{metric} exact={exact}: scores off by {err}")
        chunks = -(-len(sets) // 256)
        check(grew_ex == (REPS * chunks if exact else 0),
              f"{metric} exact={exact}: {grew_ex} exact_topk_select "
              f"launches over {REPS} batches of {chunks} query chunks")
        check(grew_rr == (0 if exact else REPS * chunks),
              f"{metric} exact={exact}: {grew_rr} flash_rerank launches "
              f"over {REPS} batches of {chunks} query chunks, want one a "
              "chunk of an approximate batch")
        if exact:
            check(grew == 0, "the exact mode launched the flash kernel")
        else:
            check(grew > 0, "approximate mode did not launch the flash kernel")
            check(bp._knn._flash_state()[0].is_cuda,
                  "flash corpus not on the card")

    # a batch of one 256-query chunk runs the exact program in both modes
    bp = ctx.prepare(sql.format(fn="l2_distance"))
    before = ft.flash_group_minima.launches
    before_ex = ex.exact_topk_select.launches
    t0 = time.perf_counter()
    res = bp.execute_batch_block(sets[:256], exact=False)
    dt_b = time.perf_counter() - t0
    grew = ft.flash_group_minima.launches - before
    grew_ex = ex.exact_topk_select.launches - before_ex
    ids, _ = _ids_scores(res, 256)
    r = recall(ids[:N_GT], d_l2, kth_l2)
    print(f"[main] execute_batch_block l2 exact=False B=256: {dt_b * 1e3:.3f} ms "
          f"(one batch), recall@10 {r}, flash launches {grew}, "
          f"exact_topk_select launches {grew_ex} [{card}]")
    check(grew == 0, "a one-chunk approximate batch launched the flash kernel")
    check(grew_ex == 1, "a one-chunk approximate batch did not run the exact "
                        "kernel once")
    check(r >= 0.99, f"one-chunk approximate batch: recall {r}")


def bm25_oracle(words, n_words, text, k):
    """Top-k of a whitespace query by BM25 (k1 = 1.2, b = 0.75, Lucene idf,
    statistics per block of BLOCK_ROWS docs, any query word matches),
    computed in f64 from the documents' words alone: ``words [n, 4]`` holds
    each doc's words, of which the first ``n_words[i]`` count. Equal scores
    rank by ascending row id. -> (row ids, scores)."""
    rows, scores = [], []
    for s in range(0, len(words), BLOCK_ROWS):
        w, nw = words[s:s + BLOCK_ROWS], n_words[s:s + BLOCK_ROWS]
        live = np.arange(4)[None, :] < nw[:, None]
        total = np.zeros(len(w))
        hit = np.zeros(len(w), bool)
        for term in text.split():
            tf = ((w == term) & live).sum(1).astype(np.float64)
            df = float((tf > 0).sum())
            idf = np.log(1.0 + (len(w) - df + 0.5) / (df + 0.5))
            total += idf * tf * 2.2 / (
                tf + 1.2 * (0.25 + 0.75 * nw / nw.mean()))
            hit |= tf > 0
        ids = np.nonzero(hit)[0]
        rows.append(ids + s)
        scores.append(total[ids].astype(np.float32))
    rows, scores = np.concatenate(rows), np.concatenate(scores)
    order = np.lexsort((rows, -scores))[:k]
    return rows[order], scores[order]


def phase_match(card, profile):
    """BM25 text serving and fused text+vector serving at the reference's
    product scale (benchmarks/hybrid_serving_bench.py), through
    SessionContext.prepare / execute / execute_batch.
    Returns the launch counts of impact_bm25_topk over the phase's served
    batches at k = 10 and of impact_bm25_scores over the batches above its
    largest k."""
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.index.inverted.device import DeviceBM25, ImpactBM25
    from databend_tpu_torch.ops.impact_bm25 import (
        MAX_K, impact_bm25_scores, impact_bm25_topk)
    from databend_tpu_torch.types import String, VectorType

    n, d = MATCH_ROWS, DIM
    rng = np.random.default_rng(MATCH_SEED)
    t0 = time.perf_counter()
    x = rng.standard_normal((n, d), dtype=np.float32)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    del x
    cats = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)]
    words = np.array(MATCH_WORDS)[rng.integers(0, len(MATCH_WORDS), (n, 4))]
    n_words = rng.integers(2, 5, n)
    texts = [" ".join(words[i, :n_words[i]]) for i in range(n)]
    print(f"[match] {n} rows x (cat, body of 2-4 words, emb {d}) in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    n_blocks = -(-n // BLOCK_ROWS)
    batches = 0

    with tempfile.TemporaryDirectory() as root:
        ctx = dt.SessionContext(root)
        try:
            ctx.sql(f"CREATE TABLE hy (id BIGINT, cat VARCHAR, body VARCHAR, "
                    f"emb VECTOR({d})) ROW_PER_BLOCK='{BLOCK_ROWS}'")
            ctx.sql("CREATE INVERTED INDEX hy_i ON hy(body)")
            t0 = time.perf_counter()
            for s in range(0, n, BLOCK_ROWS):
                e = min(s + BLOCK_ROWS, n)
                ctx.insert_block("hy", DataBlock(
                    ["id", "cat", "body", "emb"],
                    [Column.from_numpy(np.arange(s, e, dtype=np.int64)),
                     Column.from_pylist(cats[s:e].tolist(), String),
                     Column.from_pylist(texts[s:e], String),
                     Column.from_numpy(xn[s:e], VectorType(d))]))
            print(f"[match] insert + inverted index build, {n} rows in "
                  f"{n_blocks} blocks: {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")

            text_sql = ("SELECT id, score() FROM hy WHERE match(body, {t}) "
                        "ORDER BY score() DESC LIMIT 10")
            fused_sql = ("SELECT id FROM hy WHERE match(body, {t}) ORDER BY "
                         "0.04 * score() - cosine_distance(emb, {v}) DESC "
                         "LIMIT 10")
            pool = [" ".join(rng.choice(MATCH_WORDS, 2, replace=False))
                    for _ in range(1024)]
            qis = rng.integers(0, n, 128)
            Q = xn[qis] + 0.02 * rng.standard_normal((128, d)).astype(np.float32)

            def vec(v):
                return "[" + ",".join(f"{f:.6f}" for f in v) + "]"

            def same_as_generic(res, sql, what):
                want = ctx.sql(sql).rows()
                got = res.rows()
                check([r[0] for r in got] == [r[0] for r in want],
                      f"{what}: served rows {got[:3]} != generic {want[:3]}")
                if got and len(got[0]) > 1:
                    check(np.allclose([r[1] for r in got],
                                      [r[1] for r in want], rtol=1e-4),
                          f"{what}: served scores differ from generic")
                check(len(got) == K, f"{what}: {len(got)} rows")

            impact_bm25_scores.launches = 0
            impact_bm25_topk.launches = 0
            pm = ctx.prepare(text_sql.format(t="?"))
            t0 = time.perf_counter()
            first = pm.execute(pool[0])
            batches += 1
            first_s = time.perf_counter() - t0
            m = pm._match
            check(m is not None and m._snap_id is not None,
                  "the match server did not engage")
            check(len(m._scorers) == n_blocks and all(
                isinstance(sc, ImpactBM25) and sc._term_ids.is_cuda
                and sc.n_pad <= BLOCK_ROWS for sc in m._scorers),
                  "the blocks are not served by ImpactBM25 on the card")
            same_as_generic(first, text_sql.format(t=f"'{pool[0]}'"),
                            "match single")
            o_rows, o_scores = bm25_oracle(words, n_words, pool[0], K)
            got = first.rows()
            check([r[0] for r in got] == o_rows.tolist(),
                  f"match single: rows {got} != numpy BM25 {o_rows}")
            check(np.allclose([r[1] for r in got], o_scores, rtol=1e-4),
                  "match single: scores differ from numpy BM25")
            print(f"[match] prepared match() single, first call (builds and "
                  f"uploads {n_blocks} block layouts, L={m._scorers[0].L}): "
                  f"{first_s:.3f} s; rows and scores equal the generic path "
                  f"and a numpy BM25 [{card}]")
            times = []
            for i in range(1, 1 + REPS):
                t0 = time.perf_counter()
                pm.execute(pool[i])
                batches += 1
                times.append(time.perf_counter() - t0)
            print(f"[match] prepared match() single: "
                  f"{1 / float(np.median(times)):.1f} QPS (median of {REPS} "
                  f"calls, {[round(t * 1e3, 3) for t in times]} ms) [{card}]")

            def timed_batches(ps, make_sets, bsz, what, checks):
                """A checked warm-up batch, then REPS timed batches of
                fresh parameter sets."""
                nonlocal batches
                sets = make_sets(0)
                res = ps.execute_batch(sets)
                batches += 1
                check(len(res) == bsz and ps._match._snap_id is not None,
                      f"{what}: not served")
                for i in checks:
                    same_as_generic(res[i], *literal(sets[i]), f"{what}[{i}]")
                times = []
                for r in range(1, 1 + REPS):
                    sets = make_sets(r)
                    t0 = time.perf_counter()
                    res = ps.execute_batch(sets)
                    times.append(time.perf_counter() - t0)
                    batches += 1
                dt_b = float(np.median(times))
                print(f"[match] {what}: {bsz / dt_b:.1f} QPS (median of "
                      f"{REPS} batches, {[round(t * 1e3, 3) for t in times]} "
                      f"ms); batch 0 equals the generic path at {checks} "
                      f"[{card}]")

            def fused_as_generic(res, text, v, limit, what):
                """Served fused rows against the generic statement's: the
                same rows, but where the two paths round the fused value of
                a near-tie apart, a row must sit within two ranks of its
                generic rank at a generic value within 1e-6 of this rank's.
                Returns the number of such ranks."""
                want = ctx.sql(fused_sql.replace(
                    "SELECT id FROM", "SELECT id, 0.04 * score() - "
                    "cosine_distance(emb, {v}) FROM").replace(
                        "LIMIT 10", f"LIMIT {limit}").format(
                            t=f"'{text}'", v=vec(v))).rows()
                got = [r[0] for r in res.rows()]
                vals = [r[1] for r in want]
                check(len(got) == len(want) == limit,
                      f"{what}: {len(got)} rows, generic {len(want)}")
                swaps = 0
                for j, (g_row, (w_row, _)) in enumerate(zip(got, want)):
                    if g_row == w_row:
                        continue
                    near = [k for k in range(max(0, j - 2), min(
                        len(want), j + 3)) if want[k][0] == g_row]
                    swaps += 1
                    check(near and abs(vals[near[0]] - vals[j]) <= 1e-6,
                          f"{what} rank {j}: row {g_row} != generic {w_row}")
                return swaps

            def literal(ps_set):
                if isinstance(ps_set, str):
                    return (text_sql.format(t=f"'{ps_set}'"),)
                return (fused_sql.format(t=f"'{ps_set[0]}'", v=vec(ps_set[1])),)

            for bsz in (8, 128):
                timed_batches(
                    pm, lambda r, b=bsz: pool[(r * b) % 896:(r * b) % 896 + b],
                    bsz, f"prepared match() B={bsz}", (0, bsz - 1))
            # the device memory a B = 128 text call takes above what was
            # resident before it: no [b, n_pad] score block any more
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = pm.execute_batch(pool[:128])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - resident
            batches += 1
            block_bytes = 128 * BLOCK_ROWS * 4
            print(f"[match] prepared match() B=128: peak device memory "
                  f"{peak} bytes ({peak / 2**20:.3f} MiB) above the "
                  f"{resident} resident; one [128, {BLOCK_ROWS}] f32 score "
                  f"block is {block_bytes} bytes [{card}]")
            check(peak < block_bytes,
                  "a text call allocates a score block's worth of memory")
            o_rows, o_scores = bm25_oracle(words, n_words, pool[64], K)
            check([r[0] for r in res[64].rows()] == o_rows.tolist()
                  and np.allclose([r[1] for r in res[64].rows()], o_scores,
                                  rtol=1e-4),
                  "match B=128 [64]: differs from numpy BM25")

            pf = ctx.prepare(fused_sql.format(t="?", v="?"))
            timed_batches(
                pf, lambda r: [(t, list(map(float, q + 1e-6 * r)))
                               for t, q in zip(pool[:128], Q)],
                128, "prepared fused 0.04*score() - cosine_distance B=128",
                (0, 31))
            check(pf._match.shape.fused and len(pf._match._embs) == n_blocks
                  and pf._match._embs[0].is_cuda, "fused state not on the card")
            launches = impact_bm25_topk.launches
            check(launches == n_blocks * batches,
                  f"impact_bm25_topk launched {launches} times over "
                  f"{batches} batches of {n_blocks} blocks")
            check(impact_bm25_scores.launches == 0,
                  f"impact_bm25_scores launched at k = {K}")
            print(f"[match] impact_bm25_topk launches: {launches} = "
                  f"{n_blocks} blocks x {batches} served batches; "
                  f"impact_bm25_scores: 0")

            # above the selecting kernel's largest k: the scores kernel and
            # the tie-rule top-k serve the statement
            wide_sql = ("SELECT id, score() FROM hy WHERE match(body, {t}) "
                        f"ORDER BY score() DESC LIMIT {MAX_K + 1}")
            pw = ctx.prepare(wide_sql.format(t="?"))
            impact_bm25_scores.launches = 0
            impact_bm25_topk.launches = 0
            wide = pw.execute_batch(pool[:8])
            scores_launches = impact_bm25_scores.launches
            check(scores_launches == n_blocks and impact_bm25_topk.launches
                  == 0, f"LIMIT {MAX_K + 1}: launches scores "
                  f"{scores_launches}, topk {impact_bm25_topk.launches}")
            for i in (0, 7):
                want = ctx.sql(wide_sql.format(t=f"'{pool[i]}'")).rows()
                got = wide[i].rows()
                check([r[0] for r in got] == [r[0] for r in want]
                      and len(got) == MAX_K + 1 and np.allclose(
                          [r[1] for r in got], [r[1] for r in want],
                          rtol=1e-4),
                      f"LIMIT {MAX_K + 1} [{i}]: differs from the generic "
                      "path")
            print(f"[match] prepared match() LIMIT {MAX_K + 1} B=8: "
                  f"impact_bm25_scores launches {scores_launches} = "
                  f"{n_blocks} blocks x 1 batch, impact_bm25_topk 0; rows "
                  f"and scores equal the generic path at (0, 7) [{card}]")
            # the same above the largest k, fused: the kernel's dist operand
            # through SQL (the served fused shape projects no score)
            wide_fused = fused_sql.replace("LIMIT 10", f"LIMIT {MAX_K + 1}")
            pwf = ctx.prepare(wide_fused.format(t="?", v="?"))
            impact_bm25_scores.launches = 0
            impact_bm25_topk.launches = 0
            wide = pwf.execute_batch([(t, list(map(float, q)))
                                      for t, q in zip(pool[:8], Q[:8])])
            fused_launches = impact_bm25_scores.launches
            check(pwf._match is not None and pwf._match.shape.fused,
                  f"fused LIMIT {MAX_K + 1}: not served")
            check(fused_launches == n_blocks and impact_bm25_topk.launches
                  == 0, f"fused LIMIT {MAX_K + 1}: launches scores "
                  f"{fused_launches}, topk {impact_bm25_topk.launches}")
            swaps = sum(fused_as_generic(wide[i], pool[i], Q[i], MAX_K + 1,
                                         f"fused LIMIT {MAX_K + 1} [{i}]")
                        for i in (0, 7))
            scores_launches += fused_launches
            print(f"[match] prepared fused 0.04*score() - cosine_distance "
                  f"LIMIT {MAX_K + 1} B=8: impact_bm25_scores launches "
                  f"{fused_launches} = {n_blocks} blocks x 1 batch, "
                  f"impact_bm25_topk 0; rows equal the generic path at "
                  f"(0, 7) but for {swaps} rank(s) of values within 1e-6 "
                  f"[{card}]")

            # queries of 6-14 words: docs whose words differ but whose
            # (idf, saturation) products are the same set tie as on the
            # generic path, and rank by ascending row
            lrng = np.random.default_rng(MATCH_SEED + 1)
            long_texts = [" ".join(lrng.choice(MATCH_WORDS, n, replace=False))
                          for n in MATCH_LONG_TERMS]
            impact_bm25_scores.launches = 0
            impact_bm25_topk.launches = 0
            long_swaps = 0
            for ps_text, ps_fused, sql, limit in (
                    (pm, pf, text_sql, K), (pw, pwf, wide_sql, MAX_K + 1)):
                res = ps_text.execute_batch(long_texts)
                for i, text in enumerate(long_texts):
                    want = ctx.sql(sql.format(t=f"'{text}'")).rows()
                    got = res[i].rows()
                    check([r[0] for r in got] == [r[0] for r in want]
                          and len(got) == limit and np.allclose(
                              [r[1] for r in got], [r[1] for r in want],
                              rtol=1e-4),
                          f"{len(text.split())} words LIMIT {limit}: served "
                          f"rows {[r[0] for r in got][:5]} differ from the "
                          f"generic {[r[0] for r in want][:5]}")
                res = ps_fused.execute_batch(
                    [(t, list(map(float, q))) for t, q in zip(long_texts, Q)])
                long_swaps += sum(fused_as_generic(
                    res[i], text, Q[i], limit,
                    f"fused {len(text.split())} words LIMIT {limit}")
                    for i, text in enumerate(long_texts))
            check(impact_bm25_topk.launches == 2 * n_blocks
                  and impact_bm25_scores.launches == 2 * n_blocks,
                  f"6-14 words: launches topk {impact_bm25_topk.launches}, "
                  f"scores {impact_bm25_scores.launches}")
            launches += impact_bm25_topk.launches
            scores_launches += impact_bm25_scores.launches
            print(f"[match] prepared match() and fused, B={len(long_texts)} "
                  f"queries of {MATCH_LONG_TERMS} words at LIMIT {K} and "
                  f"{MAX_K + 1}: text rows and scores equal the generic path,"
                  f" fused rows but for {long_swaps} rank(s) of values within"
                  f" 1e-6 [{card}]")

            # AND with no token: no row, as on the generic path
            and_sql = text_sql.replace("match(body, {t})",
                                       "match(body, {t}, 'operator=AND')")
            pa = ctx.prepare(and_sql.format(t="?"))
            impact_bm25_topk.launches = 0
            batch = ["", "   ", "!!", pool[0]]
            res = list(pa.execute_batch(batch)) + [pa.execute("")]
            check(pa._match is not None and pa._match._snap_id is not None,
                  "AND: not served")
            for text, r in zip(batch + [""], res):
                want = ctx.sql(and_sql.format(t=f"'{text}'")).rows()
                got = r.rows()
                check([x[0] for x in got] == [x[0] for x in want]
                      and len(got) == (K if text.strip("! ") else 0),
                      f"AND {text!r}: served {len(got)} rows, generic "
                      f"{len(want)}")
            check(impact_bm25_topk.launches == 2 * n_blocks,
                  f"AND: impact_bm25_topk launched "
                  f"{impact_bm25_topk.launches} times")
            launches += impact_bm25_topk.launches
            print(f"[match] prepared match(.., 'operator=AND') B=4 with "
                  f"'', '   ', '!!' and one AND of two words, then '' alone: "
                  f"no row for the token-free texts, rows equal the generic "
                  f"path [{card}]")

            # a block holding a doc of more terms than ImpactBM25 takes:
            # the CSR scorer DeviceBM25 serves it on the card
            ctx.sql(f"CREATE TABLE lt (id BIGINT, body VARCHAR) "
                    f"ROW_PER_BLOCK='{CSR_ROWS}'")
            ctx.sql("CREATE INVERTED INDEX lt_i ON lt(body)")
            ctx.insert_block("lt", DataBlock(["id", "body"], [
                Column.from_numpy(np.arange(CSR_ROWS, dtype=np.int64)),
                Column.from_pylist(texts[:CSR_ROWS - 1] + [" ".join(
                    f"w{i}" for i in range(CSR_LONG_DOC))], String)]))
            csr_sql = text_sql.replace("FROM hy", "FROM lt")
            csr_and = and_sql.replace("FROM hy", "FROM lt")
            pl, pla = (ctx.prepare(q.format(t="?")) for q in (csr_sql, csr_and))
            csr_texts = pool[:4] + long_texts
            t0 = time.perf_counter()
            res = pl.execute_batch(csr_texts)
            csr_s = time.perf_counter() - t0
            sc = pl._match._scorers if pl._match is not None else []
            check(len(sc) == 1 and isinstance(sc[0], DeviceBM25)
                  and sc[0]._doc_ids.is_cuda,
                  f"lt: not served by DeviceBM25 on the card ({sc})")
            res = list(res) + [pl.execute(long_texts[-1])] + list(
                pla.execute_batch(["", "!!", pool[0]]))
            for text, sql, r in zip(
                    csr_texts + [long_texts[-1], "", "!!", pool[0]],
                    [csr_sql] * (len(csr_texts) + 1) + [csr_and] * 3, res):
                want = ctx.sql(sql.format(t=f"'{text}'")).rows()
                got = r.rows()
                check([x[0] for x in got] == [x[0] for x in want]
                      and len(got) == (K if text.strip("! ") else 0)
                      and np.allclose([x[1] for x in got],
                                      [x[1] for x in want], rtol=1e-4),
                      f"lt {text!r}: served rows {[x[0] for x in got][:5]} "
                      f"differ from the generic {[x[0] for x in want][:5]}")
            print(f"[match] DeviceBM25 on a {CSR_ROWS}-row block holding a "
                  f"doc of {CSR_LONG_DOC} words: prepared match() B="
                  f"{len(csr_texts)} of 2-14 words {csr_s * 1e3:.1f} ms "
                  f"(first call, builds the CSR state), single, and AND with "
                  f"'', '!!': rows and scores equal the generic path "
                  f"[{card}]")

            for what, sql in (("match()", text_sql.format(t="'{t}'")),
                              ("fused", None)):
                lats = []
                for i in range(8):
                    q_sql = sql.format(t=pool[i]) if sql else \
                        fused_sql.format(t=f"'{pool[i]}'", v=vec(Q[i]))
                    t0 = time.perf_counter()
                    ctx.sql(q_sql)
                    lats.append(time.perf_counter() - t0)
                print(f"[match] generic literal {what} statement: "
                      f"{float(np.median(lats)) * 1e3:.1f} ms per query "
                      f"(median of 8) [{card}]")
            if profile:
                fsets = [(t, list(map(float, q))) for t, q in zip(pool[:128], Q)]
                profile_call("match() B=128", card,
                             lambda r: pm.execute_batch(
                                 pool[128 * r:128 * (r + 1)]))
                profile_call("fused B=128", card,
                             lambda r: pf.execute_batch(fsets))
            return launches, scores_launches
        finally:
            ctx.close()


def hold_hnsw_to_cpu(card):
    """The port's HNSW on the card against the same code on CPU tensors, on
    inputs whose arithmetic is exact (small integers, duplicate rows) or
    whose distances all tie: the links and the ids must be equal, which
    holds the card's stable sort, first-minimum and scatter semantics to
    the CPU's (the CPU tests hold those to the reference)."""
    from databend_tpu_torch import backend
    from databend_tpu_torch.index.hnsw import build_hnsw, hnsw_search

    def on_both(fn):
        on_card = fn()
        os.environ[backend.DEVICE_ENV] = "cpu"
        try:
            return on_card, fn()
        finally:
            del os.environ[backend.DEVICE_ENV]

    check(backend.DEVICE_ENV not in os.environ and backend.device().type == "cuda",
          "the port's device is not the card")
    rng = np.random.default_rng(HNSW_SEED)
    x = rng.integers(0, 6, size=(5000, 32)).astype(np.float32)
    x[100:200] = x[0:100]
    err = 0.0
    for metric in ("l2", "ip"):
        g, g_cpu = on_both(lambda: build_hnsw(x, m=8, ef_construct=40,
                                              metric=metric, seed=5))
        check(g.num_levels == g_cpu.num_levels
              and all(np.array_equal(a, b) for a, b in zip(g.links, g_cpu.links)),
              f"{metric}: the graph built on the card is not the CPU's")
        (d, i), (d_cpu, i_cpu) = on_both(
            lambda: hnsw_search(g, backend.to_device(x), x[:64] + 0.25, K))
        check(np.array_equal(i, i_cpu), f"{metric}: ids differ from the CPU's")
        err = max(err, float(np.abs(d - d_cpu).max()))
    ones = np.ones((300, 8), np.float32)
    g = build_hnsw(ones, m=4, ef_construct=16, metric="l2", seed=1)
    (d, i), (d_cpu, i_cpu) = on_both(
        lambda: hnsw_search(g, backend.to_device(ones), ones[:3], 8))
    check(np.array_equal(i, i_cpu) and np.array_equal(d, d_cpu),
          "equal rows: the card breaks ties another way than the CPU")
    print(f"[hnsw] card vs CPU tensors, 5,000 x 32 integer rows (l2, ip) and "
          f"300 equal rows: graphs equal, ids equal, max |distance "
          f"difference| {err} [{card}]")
    check(err <= 1e-5, f"distances differ from the CPU's by {err}")


def phase_hnsw(card, profile):
    """HNSW on the card: graphs built at insert, beam search from SQL, and
    ``hnsw_search`` alone at three batch sizes."""
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.index.hnsw import hnsw_search
    from databend_tpu_torch.index.hnsw.build import BUILD_STAGES
    from databend_tpu_torch.index.hnsw.search import postprocess_scores
    from databend_tpu_torch.ops.exact_topk import exact_topk_select
    from databend_tpu_torch.types import VectorType
    from databend_tpu_torch.utils.metrics import METRICS

    def counter(name):
        return METRICS.snapshot().get(name, 0)

    hold_hnsw_to_cpu(card)
    rng = np.random.default_rng(HNSW_SEED)
    centers = rng.integers(0, 256, size=(HNSW_CENTERS, DIM)).astype(np.float32)
    x = sift_like(rng, HNSW_ROWS, centers)
    queries = sift_like(rng, 1024, centers)
    d_cos, kth = ground_truth(x, queries[:N_GT], "cosine")
    with tempfile.TemporaryDirectory() as root:
        ctx = dt.SessionContext(root)
        try:
            ctx.sql(f"CREATE TABLE h (id BIGINT, emb VECTOR({DIM})) "
                    f"ROW_PER_BLOCK='{BLOCK_ROWS}'")
            ctx.sql("CREATE VECTOR INDEX hv ON h(emb) distance='cosine' "
                    f"graphs='always' m='{HNSW_M}' "
                    f"ef_construct='{HNSW_EF_CONSTRUCT}'")
            done = {s: len(METRICS.histograms[f"hnsw_build_{s}_seconds"])
                    for s in BUILD_STAGES}
            exact_topk_select.launches = 0
            t0 = time.perf_counter()
            ctx.insert_block("h", DataBlock(
                ["id", "emb"],
                [Column.from_numpy(np.arange(HNSW_ROWS, dtype=np.int64)),
                 Column.from_numpy(x, VectorType(DIM))]))
            insert_s = time.perf_counter() - t0
            build_launches = exact_topk_select.launches
            table = ctx.table("h")
            metas = [m for seg in table.read_segments(table.read_snapshot())
                     for m in seg.blocks]
            stages = {s: METRICS.histograms[f"hnsw_build_{s}_seconds"][done[s]:]
                      for s in BUILD_STAGES}
            check(all(len(v) == len(metas) for v in stages.values()),
                  f"{len(metas)} blocks, build stages timed "
                  f"{ {s: len(v) for s, v in stages.items()} }")
            for bi, meta in enumerate(metas):
                split = ", ".join(f"{s} {stages[s][bi]:.3f}" for s in BUILD_STAGES)
                print(f"[hnsw] build block {bi} ({meta.row_count} rows x {DIM}, "
                      f"m={HNSW_M}, ef_construct={HNSW_EF_CONSTRUCT}, cosine): "
                      f"{sum(stages[s][bi] for s in BUILD_STAGES):.3f} s "
                      f"({split}) [{card}]")
            print(f"[hnsw] create + insert {HNSW_ROWS} rows with a graph on "
                  f"each of {len(metas)} blocks: {insert_s:.1f} s; the kNN "
                  f"graphs launched exact_topk_select {build_launches} times "
                  f"[{card}]")
            check(build_launches > 0, "[hnsw] the build launched "
                                      "exact_topk_select no time")
            graphs = [table.load_vector_graph(m, "hv", "cosine") for m in metas]
            check(all(g is not None and g.num_points == m.row_count
                      and g.m0 == 2 * HNSW_M for g, m in zip(graphs, metas)),
                  "a block has no graph of its size")

            ctx.sql("SET vector_search_mode = 'hnsw'")
            sql = "SELECT id FROM h ORDER BY cosine_distance(emb, {}) LIMIT 10"
            lits = ["[" + ",".join(str(int(v)) for v in q) + "]"
                    for q in queries[:N_GT]]
            plan = "\n".join(r[0] for r in
                             ctx.sql("EXPLAIN " + sql.format(lits[0])).rows())
            check("vector_index=hv" in plan and "hnsw=on" in plan,
                  f"EXPLAIN does not show the index: {plan}")
            ctx.sql(sql.format(lits[0])).rows()        # loads the columns
            searches = counter("hnsw_search_batches")
            ids, times = [], []
            for lit in lits:
                t0 = time.perf_counter()
                rows = ctx.sql(sql.format(lit)).rows()
                times.append(time.perf_counter() - t0)
                ids.append([i for (i,) in rows])
            searches = counter("hnsw_search_batches") - searches
            check(searches == N_GT * len(metas),
                  f"{searches} beam searches for {N_GT} statements over "
                  f"{len(metas)} blocks")
            ids = np.array(ids)
            r = recall(ids, d_cos, kth)

            # the same answer from hnsw_search on the loaded graphs, by hand
            xs = [table.device_vectors(m, "emb", normalized=True) for m in metas]
            check(all(t.is_cuda for t in xs), "a block's vectors are not on the card")
            offsets = np.cumsum([0] + [m.row_count for m in metas])
            err, same = 0.0, 0
            for qi in range(N_GT):
                cand = []
                for bi, (g, xd) in enumerate(zip(graphs, xs)):
                    d, i = hnsw_search(g, xd, queries[qi:qi + 1], K)
                    d = postprocess_scores(d, "cosine")
                    cand += [(float(s), int(offsets[bi] + r_))
                             for s, r_ in zip(d[0], i[0]) if r_ >= 0]
                cand.sort(key=lambda t: t[0])
                top = cand[:K]
                same += sorted(i for _, i in top) == sorted(ids[qi].tolist())
                err = max(err, max(abs(s - d_cos[qi, i]) for s, i in top))
            print(f"[hnsw] literal ctx.sql KNN, vector_search_mode='hnsw', "
                  f"k={K}, ef={4 * K}: median {np.median(times) * 1e3:.3f} ms a "
                  f"statement over {len(metas)} blocks "
                  f"({[round(t * 1e3, 1) for t in times]}), recall@10 {r} on "
                  f"{N_GT} queries, {same} of {N_GT} id sets equal to the "
                  f"direct search, max |distance - f64| {err} [{card}]")
            check(r >= HNSW_RECALL, f"hnsw recall {r} < {HNSW_RECALL}")
            check(same == N_GT, "the statement and the direct search differ")
            check(err <= 1e-3, f"hnsw distances off by {err}")

            # a wider beam must find more: the N_GT queries as one batch a
            # block, merged over the blocks
            sweep = {}
            for ef in HNSW_EF_SWEEP:
                per_block = [hnsw_search(g, xd, queries[:N_GT], K, ef=ef)
                             for g, xd in zip(graphs, xs)]
                d = np.concatenate([p[0] for p in per_block], axis=1)
                i = np.concatenate([p[1] + offsets[bi] for bi, p
                                    in enumerate(per_block)], axis=1)
                top = np.argsort(d, axis=1, kind="stable")[:, :K]
                sweep[ef] = recall(np.take_along_axis(i, top, 1), d_cos, kth)
            print(f"[hnsw] recall@10 by ef, {N_GT} queries as one batch a "
                  f"block: {sweep} [{card}]")
            check(all(a <= b + 0.02 for a, b in zip(list(sweep.values()),
                                                    list(sweep.values())[1:])),
                  f"recall falls with a wider beam: {sweep}")
            check(sweep[HNSW_EF_SWEEP[-1]] >= HNSW_RECALL_WIDE,
                  f"recall at ef={HNSW_EF_SWEEP[-1]}: {sweep}")

            # hnsw_search alone on block 0
            g, xd = graphs[0], xs[0]
            top0 = np.argsort(d_cos[:, :g.num_points], axis=1)[:, :K]
            for b in (1, 256, 1024):
                # B = 1: each of the N_GT queries alone; else one batch, REPS times
                batches = [queries[j:j + 1] for j in range(N_GT)] if b == 1 \
                    else [queries[:b]] * REPS
                q = batches[0]
                hnsw_search(g, xd, q, K)                           # warm
                steps = counter("hnsw_search_steps")
                bt, found = [], []
                for qb in batches:
                    t0 = time.perf_counter()
                    d, i = hnsw_search(g, xd, qb, K)
                    bt.append(time.perf_counter() - t0)
                    check(np.isfinite(d).all() and (i >= 0).all()
                          and (i < g.num_points).all(),
                          f"B={b}: bad search result")
                    found.append(i)
                steps = (counter("hnsw_search_steps") - steps) / len(batches)
                found = np.concatenate(found)[:N_GT] if b == 1 else found[-1]
                nq = min(len(found), N_GT)
                rb = float(np.mean([len(set(found[j]) & set(top0[j])) / K
                                    for j in range(nq)]))
                ms = float(np.median(bt)) * 1e3
                print(f"[hnsw] hnsw_search one block ({g.num_points} rows) "
                      f"B={b}: {ms:.3f} ms a batch (median of {len(bt)}, "
                      f"{[round(t * 1e3, 3) for t in bt]}), {b / ms * 1e3:.1f} "
                      f"QPS, {steps:.0f} level-0 steps of at most "
                      f"{2 * 4 * K + 16}, {ms / steps:.4f} ms a step, recall@10 "
                      f"{rb} on {nq} queries against the block's own truth "
                      f"[{card}]")
                check(rb >= HNSW_RECALL, f"B={b}: recall {rb}")
                if profile:
                    whole, busy, items = profile_call(
                        f"hnsw_search B={b}", card,
                        lambda r: hnsw_search(g, xd, q, K))
                    print(f"[profile] hnsw_search B={b}: {items / steps:.1f} "
                          f"device items a step, {busy / steps * 1e3:.1f} us "
                          f"busy of {whole / steps * 1e3:.1f} us a step "
                          f"[{card}]")
            return build_launches
        finally:
            ctx.close()


def phase_cluster(card):
    """CLUSTER BY over a vector column: k-means on the card at the
    reference's operating point, then a KNN query on the clustered table."""
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.index import kmeans
    from databend_tpu_torch.types import VectorType

    rng = np.random.default_rng(SEED + 1)
    centers = rng.integers(0, 256, size=(1000, DIM)).astype(np.float32)
    x = sift_like(rng, CLUSTER_ROWS, centers)
    queries = sift_like(rng, N_GT, centers)
    d_l2, kth = ground_truth(x, queries, "l2")
    seen = {"devices": set()}
    real_lloyd, real_layout = kmeans._lloyd, kmeans.cluster_layout

    def lloyd(xt, init, iters=10):
        seen["devices"].add(xt.device.type)
        return real_lloyd(xt, init, iters)

    def layout(vectors, *a, **kw):
        seen["order"], seen["runs"] = real_layout(vectors, *a, **kw)
        return seen["order"], seen["runs"]

    kmeans._lloyd, kmeans.cluster_layout = lloyd, layout
    try:
        with tempfile.TemporaryDirectory() as root:
            ctx = dt.SessionContext(root)
            try:
                ctx.sql(f"CREATE TABLE c (id BIGINT, emb VECTOR({DIM}), "
                        "VECTOR INDEX cv (emb) distance='l2') CLUSTER BY (emb)")
                t0 = time.perf_counter()
                ctx.insert_block("c", DataBlock(
                    ["id", "emb"],
                    [Column.from_numpy(np.arange(CLUSTER_ROWS, dtype=np.int64)),
                     Column.from_numpy(x, VectorType(DIM))]))
                insert_s = time.perf_counter() - t0
                t = ctx.table("c")
                blocks = sum(len(seg.blocks)
                             for seg in t.read_segments(t.read_snapshot()))
                ids = []
                for q in queries:
                    lit = "[" + ",".join(str(int(v)) for v in q) + "]"
                    rows = ctx.sql(f"SELECT id FROM c ORDER BY "
                                   f"l2_distance(emb, {lit}) LIMIT 10").rows()
                    ids.append([i for (i,) in rows])
            finally:
                ctx.close()
    finally:
        kmeans._lloyd, kmeans.cluster_layout = real_lloyd, real_layout
    order, runs = seen.get("order"), seen.get("runs")
    r = recall(np.array(ids), d_l2, kth)
    print(f"[cluster] insert {CLUSTER_ROWS} rows x {DIM} with CLUSTER BY (emb): "
          f"{insert_s:.3f} s (k-means on {sorted(seen['devices'])}, "
          f"{len(runs or [])} cluster runs, {blocks} blocks), KNN recall@10 "
          f"{r} on {N_GT} queries [{card}]")
    check(seen["devices"] == {"cuda"}, f"k-means ran on {seen['devices']}")
    check(order is not None and np.array_equal(np.sort(order),
                                               np.arange(CLUSTER_ROWS)),
          "the cluster order is not a permutation of the rows")
    check(sum(runs) == CLUSTER_ROWS, f"cluster runs cover {sum(runs)} rows")
    check(r >= 0.99, f"clustered KNN recall {r}")


# --------------------------------------------------------- [sq8], [mesh]


def device_busy(call, reps=3, skip=None):
    """(whole-call ms on the host clock, device-busy ms: the summed time of
    the profiler's device-side events, but those whose name holds ``skip``)
    per call of ``call()``, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) / reps * 1e3
    busy = sum(_device_us(e) for e in _kernels(prof.key_averages())
               if skip is None or skip not in e.key.lower()) / reps / 1e3
    check(busy > 0, "the profiler saw no device time")
    return whole, busy


def phase_sq8(card, x, queries, gt):
    """SQ-u8 scoring (``ops/quantization.py``) on the main path's corpus:
    ``encode`` at quantile 0.99, ``approx_dot`` on a [16, N] slice against
    the same formula over integer products in numpy, then ``topk_l2`` at
    B = SQ8_B, k = 10, shortlist 4, with and without the f32 re-rank
    (recall@10 on the N_GT queries with a ground truth, whole call and
    device busy), and the int8 product's exact f32 route beside
    ``torch._int_mm`` on the same codes (a library yardstick, not on the
    path)."""
    from databend_tpu_torch import backend
    from databend_tpu_torch.ops import quantization as sq

    d_l2, kth = gt["l2"]
    t0 = time.perf_counter()
    corpus = sq.encode(x, 0.99)
    torch.cuda.synchronize()
    m = corpus.meta
    print(f"[sq8] encode {x.shape[0]} x {x.shape[1]} at quantile 0.99: "
          f"{time.perf_counter() - t0:.1f} s (host fit + upload), alpha "
          f"{m.alpha:.6f}, offset {m.offset} [{card}]")
    check(corpus.codes.is_cuda and corpus.codes.dtype == torch.int8,
          "the SQ-u8 codes are not int8 on the card")

    # approx_dot: integer products summed exactly in f64 (every partial sum
    # an integer below 2^53), the three terms in f64; the port's f32 terms
    # may each round once, and so may their two sums
    qc, qs = sq.encode_query(queries[:N_GT], m)
    got = backend.to_numpy(sq.approx_dot(qc, qs, corpus)).astype(np.float64)
    idot = backend.to_numpy(qc).astype(np.float64) \
        @ backend.to_numpy(corpus.codes).astype(np.float64).T
    beta = m.alpha * 128.0 + m.offset
    terms = (m.alpha * m.alpha * idot,
             m.alpha * beta * (backend.to_numpy(qs)[:, None].astype(np.float64)
                               + backend.to_numpy(corpus.sums)[None, :]),
             np.full(idot.shape, m.dim * beta * beta))
    want = terms[0] + terms[1] + terms[2]
    tol = 4 * 2.0 ** -24 * sum(np.abs(t) for t in terms)
    err = float(np.abs(got - want).max())
    print(f"[sq8] approx_dot [{N_GT}, {x.shape[0]}] against numpy: max |err| "
          f"{err} (bound 4 ulp of the terms, at most {float(tol.max())}) "
          f"[{card}]")
    check(bool((np.abs(got - want) <= tol).all()),
          f"approx_dot off the numpy formula by {err}")

    x_dev = backend.to_device(x)
    q = queries[:SQ8_B]
    need = {False: 0.0, True: 0.95}
    for rerank in (False, True):
        def call(rerank=rerank):
            return sq.topk_l2(q, corpus, K, x_f32=x_dev if rerank else None)
        vals, ids = call()
        vals, ids = backend.to_numpy(vals), backend.to_numpy(ids)
        check(ids.shape == (SQ8_B, K) and np.isfinite(vals).all(),
              f"[sq8] rerank={rerank}: shape {ids.shape} or non-finite values")
        r = recall(ids[:N_GT].astype(np.int64), d_l2, kth)
        whole, busy = device_busy(call)
        print(f"[sq8] topk_l2 B={SQ8_B} k={K} shortlist 4 rerank={rerank}: "
              f"whole call {whole:.3f} ms, device busy {busy:.3f} ms, "
              f"recall@10 {r} on {N_GT} queries [{card}]")
        check(r >= need[rerank], f"[sq8] rerank={rerank}: recall {r}")
    del x_dev

    # the int8 product: the exact f32 route against the library's int8
    # product on the same codes (one read of the codes and one write of the
    # [B, N] int32 result at the memory rate is its bound)
    qc, _ = sq.encode_query(q, m)
    ours = sq.int8_dot(qc, corpus.codes)
    lib = torch._int_mm(qc, corpus.codes.T)
    check(torch.equal(ours, lib), "[sq8] int8_dot differs from torch._int_mm")
    del ours, lib
    f32_ms = cuda_ms(lambda: sq.int8_dot(qc, corpus.codes))
    lib_ms = cuda_ms(lambda: torch._int_mm(qc, corpus.codes.T))
    n = corpus.codes.shape[0]
    bound = (corpus.codes.numel() + qc.numel() + 4 * SQ8_B * n) \
        / HBM_BYTES_PER_S * 1e3
    print(f"[sq8] int8 product [{SQ8_B}, {m.dim}] x [{n}, {m.dim}]: exact f32 "
          f"route {f32_ms:.3f} ms, torch._int_mm {lib_ms:.3f} ms (equal), "
          f"bound {bound:.3f} ms (bytes) [{card}]")


def mesh_devices(n):
    """n devices for an n-shard mesh: one card each where there are n
    cards, else n logical shards of cuda:0."""
    if torch.cuda.device_count() >= n:
        return ([torch.device("cuda", i) for i in range(n)],
                f"one shard a card on {n} cards")
    return [torch.device("cuda", 0)] * n, f"{n} logical shards of cuda:0"


def mesh_truth(x, q):
    """Squared l2 distances [B, N] in f64, 1M rows at a time, and the
    top-k ids by (distance, id)."""
    q64 = q.astype(np.float64)
    d = np.empty((q.shape[0], x.shape[0]))
    for s in range(0, x.shape[0], 1 << 20):
        xs = x[s:s + (1 << 20)].astype(np.float64)
        d[:, s:s + xs.shape[0]] = (xs * xs).sum(1)[None, :] \
            - 2.0 * (q64 @ xs.T) + (q64 * q64).sum(1)[:, None]
    top = np.argpartition(d, K, axis=1)[:, :K]
    order = np.lexsort((top, np.take_along_axis(d, top, 1)), axis=1)
    return d, np.take_along_axis(top, order, 1)


def phase_mesh(card, work):
    """BASELINE configuration 5 at Deep10M's shape
    (benchmarks/mesh_knn_bench.py): MESH_ROWS x MESH_DIM standard normal
    rows (seed MESH_SEED) row-sharded over a MESH_SHARDS-shard mesh, the
    exact sharded top-k (B = MESH_B, k = 10, l2) in f32 and bf16; then
    ``sharded_search_step`` on a (2, 2) mesh. The rows and queries are
    written to ``work`` for [multihost]; returns the f32 ids, the f64
    truth's ids and its k-th distances."""
    from databend_tpu_torch import backend, parallel
    from databend_tpu_torch.ops.exact_topk import exact_topk_select
    from databend_tpu_torch.ops.topk import chunked_topk_smallest
    from databend_tpu_torch.parallel import distributed
    from databend_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(MESH_SEED)
    t0 = time.perf_counter()
    x = np.empty((MESH_ROWS, MESH_DIM), np.float32)
    for s in range(0, MESH_ROWS, 1 << 20):
        e = min(MESH_ROWS, s + (1 << 20))
        x[s:e] = rng.standard_normal((e - s, MESH_DIM), dtype=np.float32)
    q = rng.standard_normal((MESH_B, MESH_DIM), dtype=np.float32)
    d, truth = mesh_truth(x, q)
    print(f"[mesh] {MESH_ROWS} x {MESH_DIM} rows + f64 truth in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    t0 = time.perf_counter()
    np.save(os.path.join(work, "mesh_x.npy"), x)
    np.save(os.path.join(work, "mesh_q.npy"), q)
    print(f"[mesh] rows written for [multihost] ({x.nbytes / 2 ** 30:.2f} "
          f"GiB): {time.perf_counter() - t0:.1f} s (host)")

    devs, how = mesh_devices(MESH_SHARDS)
    m = pm.make_mesh(MESH_SHARDS, devices=devs)
    t0 = time.perf_counter()
    x_dev, n_valid = parallel.shard_rows(x, m)
    for dev in set(devs):
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    q_dev = pm.device_put(q, parallel.query_sharding(m))

    def run(bf16):
        dv, iv = parallel.sharded_brute_force_topk(
            m, q_dev, x_dev, K, "l2", bf16=bf16, n_valid=n_valid)
        return np.asarray(dv), np.asarray(iv)

    def timed(bf16):
        t0 = time.perf_counter()
        dv, iv = run(bf16)
        first = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(bf16)
            warm.append((time.perf_counter() - t0) * 1e3)
        return dv, iv, first, float(np.median(warm))

    exact_topk_select.launches = 0
    dv, iv, first, warm = timed(False)
    mesh_launches = exact_topk_select.launches
    x_one = torch.cat([b.to(devs[0]) for b in x_dev.shards()])
    sv, si = chunked_topk_smallest(backend.to_device(q, device=devs[0]),
                                   x_one, K, "l2")
    del x_one
    si = backend.to_numpy(si)
    true = np.sqrt(np.maximum(np.take_along_axis(d, truth, 1), 0.0))
    r = recall(iv.astype(np.int64), d, np.take_along_axis(d, truth, 1)
               .max(1))
    err = float(np.abs(dv - true).max())
    print(f"[mesh] {how}: upload {upload_s:.2f} s ({x.nbytes / 2 ** 30:.2f} "
          f"GiB), f32 B={MESH_B} k={K}: first batch {first:.1f} ms, warm "
          f"{warm:.1f} ms (median of 3), recall@10 {r}, ids equal to the "
          f"single-device chunked_topk_smallest: {np.array_equal(iv, si)}, "
          f"to the f64 truth: {np.array_equal(iv, truth)}, max |d - f64| "
          f"{err}; exact_topk_select launches {mesh_launches} over 4 batches "
          f"[{card}]")
    check(mesh_launches > 0, "[mesh] the f32 batches launched "
                             "exact_topk_select no time")
    check(np.array_equal(iv, si), "[mesh] f32 ids differ from the "
                                  "single-device scan")
    check(r == 1.0, f"[mesh] f32 recall {r}")
    check(err <= 1e-3 * float(true.max()), f"[mesh] distances off by {err}")

    knn_ref = {"ids": iv, "truth": truth,
               "kth": np.take_along_axis(d, truth, 1).max(1),
               "exact_launches": mesh_launches}
    bv, bi, first, warm = timed(True)
    rb = recall(bi.astype(np.int64), d, knn_ref["kth"])
    print(f"[mesh] bf16 B={MESH_B} k={K}: first batch {first:.1f} ms, warm "
          f"{warm:.1f} ms (median of 3), recall@10 {rb} [{card}]")
    check(rb >= 0.95, f"[mesh] bf16 recall {rb}")
    rows = MESH_ROWS // MESH_SHARDS
    busy = []
    for j, blk in enumerate(x_dev.shards()):
        busy.append(device_busy(lambda j=j, blk=blk: distributed.local_topk(
            q_dev.block(0, j), blk, K, "l2", rows, j, 131072, False,
            n_valid))[1])
    whole, all_busy = device_busy(lambda: run(False))
    print(f"[mesh] device busy per shard, f32 local scan of {rows} rows: "
          f"{[round(b, 3) for b in busy]} ms; a whole f32 batch: "
          f"{whole:.3f} ms, device busy {all_busy:.3f} ms, idle share "
          f"{100 * (1 - all_busy / whole):.0f}% [{card}]")
    del x_dev

    # the flagship step: dp = 2 over the query batch, 2 corpus shards. Rows
    # rounded to integers (x * 4): every distance and every cluster sum is
    # exact in f32 and in bf16, so the Lloyd step has one right answer
    xs = np.rint(x[:STEP_ROWS] * 4.0)
    del x, d
    cent = xs[:STEP_CENTROIDS].copy()
    qs = xs[rng.integers(0, STEP_ROWS, MESH_B)] + 1.0
    devs, how = mesh_devices(4)
    m2 = pm.make_mesh(4, dp=2, devices=devs)
    xs_dev, _ = parallel.shard_rows(xs, m2)
    qs_dev = pm.device_put(qs, parallel.query_sharding(m2))
    c_dev = pm.device_put(cent, parallel.replicated(m2))

    def step():
        return parallel.sharded_search_step(m2, qs_dev, xs_dev, c_dev, K)

    _, ids, new, counts = step()
    t0 = time.perf_counter()
    for _ in range(3):
        out = step()
    np.asarray(out[3])
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    ids, new, counts = np.asarray(ids), np.asarray(new), np.asarray(counts)
    dd = (xs * xs).sum(1)[:, None] - 2.0 * (xs @ cent.T) \
        + (cent * cent).sum(1)[None, :]
    assign = np.argmin(dd, axis=1)
    cnt = np.bincount(assign, minlength=STEP_CENTROIDS)
    sums = np.zeros_like(cent)
    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], np.arange(STEP_CENTROIDS))
    live = cnt > 0
    sums[live] = np.add.reduceat(xs[order], starts[live], axis=0)
    ref = np.where(cnt[:, None] > 0, sums / np.maximum(cnt[:, None], 1), cent)
    cerr = float(np.abs(new - ref).max())
    ds, ts = mesh_truth(xs, qs)
    rs = recall(ids.astype(np.int64), ds, np.take_along_axis(ds, ts, 1)
                .max(1))
    print(f"[mesh] sharded_search_step on a (2, 2) mesh ({how}), "
          f"{STEP_ROWS} rows, {STEP_CENTROIDS} centroids, bf16 top-k: "
          f"{step_ms:.1f} ms a step (mean of 3), counts sum "
          f"{int(counts.sum())}, equal to numpy: "
          f"{np.array_equal(counts, cnt)}, max |centroid - numpy Lloyd| "
          f"{cerr}, recall@10 {rs} [{card}]")
    check(int(counts.sum()) == STEP_ROWS, "[mesh] counts do not sum to n")
    check(np.array_equal(counts, cnt), "[mesh] counts differ from numpy")
    check(cerr <= 1e-4 * float(np.abs(ref).max()),
          f"[mesh] centroids off the numpy Lloyd step by {cerr}")
    check(rs == 1.0, f"[mesh] search-step recall {rs}")
    return knn_ref


# ------------------------------------------------------------------ [dist]


DIST_STATEMENTS = [
    ("group_by", "psum merge", ["sharded_grouped_agg"],
     "SELECT l_suppkey, count(*), sum(l_quantity), min(l_quantity), "
     "max(l_quantity), sum(l_extendedprice) FROM lineitem "
     "GROUP BY l_suppkey ORDER BY l_suppkey"),
    ("agg_topn_psum", "AggTopNFragment, psum", ["sharded_grouped_agg_topn"],
     "SELECT l_suppkey, sum(l_extendedprice) AS revenue, count(*) AS c "
     "FROM lineitem GROUP BY l_suppkey HAVING count(*) > 550 "
     "ORDER BY revenue DESC LIMIT 10"),
    ("agg_topn_shuffle", "AggTopNFragment, shuffle",
     ["sharded_grouped_agg_topn"],
     "SELECT l_partkey, sum(l_extendedprice) AS revenue FROM lineitem "
     "GROUP BY l_partkey HAVING count(*) > 30 ORDER BY revenue DESC "
     "LIMIT 10"),
    ("order_by_limit", "ordered merge", ["sharded_topn"],
     "SELECT l_orderkey, l_partkey, l_extendedprice FROM lineitem "
     "ORDER BY l_extendedprice DESC, l_orderkey LIMIT 100"),
    ("order_by_full", "range-partition sort", ["range_partition_sort"],
     "SELECT o_orderkey, o_totalprice FROM orders "
     "ORDER BY o_totalprice, o_orderkey"),
    ("join", "broadcast join", ["broadcast_lookup_join"],
     "SELECT o_orderpriority, count(*), sum(l_quantity) FROM lineitem "
     "JOIN orders ON l_orderkey = o_orderkey GROUP BY o_orderpriority "
     "ORDER BY o_orderpriority"),
    ("window", "key shuffle", ["shuffle_by_key"],
     "SELECT o_orderkey, row_number() OVER (PARTITION BY o_custkey "
     "ORDER BY o_orderdate, o_orderkey) AS rn FROM orders "
     "ORDER BY o_orderkey LIMIT 1000"),
]


def dist_same(want, got):
    """Rows of two result blocks alike: integer and string columns equal; a
    float column whose host values are all integers below 2^24 (counts,
    integer sums, min / max of an integer column) equal; other float
    columns within rel DIST_RTOL, the exchanges' f32 contract."""
    wc, gc = list(want.items()), list(got.items())
    if [n for n, _ in wc] != [n for n, _ in gc] \
            or want.num_rows != got.num_rows:
        return False
    for (_, a), (_, b) in zip(wc, gc):
        if (a.validity is None) != (b.validity is None) or (
                a.validity is not None
                and not np.array_equal(a.validity, b.validity)):
            return False
        if not isinstance(a.data, np.ndarray):
            if a.to_pylist() != b.to_pylist():
                return False
            continue
        keep = slice(None) if a.validity is None else a.validity
        x, y = a.data[keep], np.asarray(b.data)[keep]
        if x.dtype.kind != "f" and y.dtype.kind != "f":
            if not np.array_equal(x, y):
                return False
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        if np.all((np.abs(x) < 2 ** 24) & (x == np.rint(x))):
            if not np.array_equal(x, y):
                return False
        elif not np.all(np.abs(x - y) <= DIST_RTOL * np.abs(x)):
            return False
    return True


def spy_exchanges(calls):
    """Count the calls of each exchange entry point in ``calls``; returns
    the function that puts the real ones back."""
    from databend_tpu_torch import parallel
    from databend_tpu_torch.parallel import exchange, fragmenter
    real = {}
    spied = [(exchange, n) for n in (
        "sharded_grouped_agg", "sharded_shuffle_grouped_agg", "sharded_topn",
        "range_partition_sort", "broadcast_lookup_join", "ShuffleJoin",
        "shuffle_by_key")] + [(fragmenter, "sharded_grouped_agg_topn"),
                              (parallel, "sharded_brute_force_topk")]

    def counted(name, fn):
        def spy(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return spy

    for mod, name in spied:
        real[(mod, name)] = getattr(mod, name)
        setattr(mod, name, counted(name, real[(mod, name)]))

    def restore():
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return restore


def phase_dist(card, ctx, profile):
    """Distributed SQL on the card in the [tpch] session (TPC-H SF1, seed
    42) under an installed mesh of 4 shards: each of DIST_STATEMENTS with
    ``enable_distributed_execution`` off, then on (the device-local routes
    off, so that the host operator and the exchange answer), twice each;
    rows alike (``dist_same``), the exchange it is meant for called, the
    warm call of each timed. Then a literal KNN statement over a
    DIST_VEC_ROWS-row table (above ``vector_host_scan_max_rows``) with
    ``enable_distributed_pruning`` off, then on: the mesh-sharded prune
    runs, ids equal. With --profile, each statement's warm call with the
    setting on under torch.profiler. Returns each statement's result block
    with the setting on."""
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.parallel import mesh as pm
    from databend_tpu_torch.types import VectorType

    devs, how = mesh_devices(4)
    calls = {}
    on_rows = {}
    restore = spy_exchanges(calls)
    old = pm.set_default_mesh(pm.make_mesh(4, devices=devs))
    print(f"[dist] mesh: {how}; the device-local routes off for the "
          "comparison")
    ctx.sql("SET enable_device_local_execution = 0")
    try:
        for name, what, names, sql in DIST_STATEMENTS:
            times = {}
            for on in (0, 1):
                ctx.sql(f"SET enable_distributed_execution = {on}")
                calls.clear()
                ctx.sql(sql)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = ctx.sql(sql)
                torch.cuda.synchronize()
                times[on] = (time.perf_counter() - t0) * 1e3
                if on:
                    got, took = res, dict(calls)
                else:
                    want = res
            ctx.sql("SET enable_distributed_execution = 0")
            on_rows[name] = got.block
            ok = dist_same(want.block, got.block)
            print(f"[dist] {name} ({what}, {want.block.num_rows} rows): "
                  f"warm off {times[0]:.1f} ms, on {times[1]:.1f} ms; calls "
                  f"{took}; rows alike: {ok} [{card}]")
            check(all(took.get(n, 0) >= 2 for n in names),
                  f"[dist] {name}: {names} not called: {took}")
            check(ok, f"[dist] {name}: rows differ from the host's: "
                      f"{want.rows()[:3]} vs {got.rows()[:3]}")
            if profile:
                ctx.sql("SET enable_distributed_execution = 1")
                profile_call(f"[dist] {name} warm call, setting on", card,
                             lambda r, sql=sql: ctx.sql(sql))
                ctx.sql("SET enable_distributed_execution = 0")

        vrng = np.random.default_rng(MESH_SEED + 1)
        xv = vrng.standard_normal((DIST_VEC_ROWS, MESH_DIM), dtype=np.float32)
        ctx.sql(f"CREATE TABLE dv (id BIGINT, emb VECTOR({MESH_DIM})) "
                "ROW_PER_BLOCK='65536'")
        ctx.insert_block("dv", DataBlock(
            ["id", "emb"],
            [Column.from_numpy(np.arange(DIST_VEC_ROWS, dtype=np.int64)),
             Column.from_numpy(xv, VectorType(MESH_DIM))]))
        # created after the writes: no block has a graph, the exact scan runs
        ctx.sql("CREATE VECTOR INDEX dvi ON dv(emb) ASYNC distance='l2'")
        qv = xv[17] + 0.01
        lit = "[" + ",".join(f"{v:.6f}" for v in qv) + "]"
        sql = f"SELECT id FROM dv ORDER BY l2_distance(emb, {lit}) LIMIT 10"
        times = {}
        for on in (0, 1):
            ctx.sql(f"SET enable_distributed_pruning = {on}")
            calls.clear()
            ctx.sql(sql)
            t0 = time.perf_counter()
            rows = ctx.sql(sql).rows()
            torch.cuda.synchronize()
            times[on] = (time.perf_counter() - t0) * 1e3
            if on:
                got, took = rows, dict(calls)
            else:
                want = rows
        ctx.sql("SET enable_distributed_pruning = 1")
        truth = np.argsort(((xv - qv) ** 2).sum(1), kind="stable")[:10]
        print(f"[dist] vector_prune (mesh-sharded exact top-k, "
              f"{DIST_VEC_ROWS} rows): warm off {times[0]:.1f} ms, on "
              f"{times[1]:.1f} ms; calls {took}; ids equal: {got == want}, "
              f"to numpy: {[r[0] for r in got] == truth.tolist()} [{card}]")
        check(took.get("sharded_brute_force_topk", 0) == 2,
              f"[dist] the distributed prune did not run: {took}")
        check(got == want and [r[0] for r in got] == truth.tolist(),
              f"[dist] vector_prune ids {got} vs {want}")
    finally:
        pm.set_default_mesh(old)
        ctx.sql("SET enable_device_local_execution = 1")
        ctx.sql("SET enable_distributed_execution = 0")
        restore()
    return on_rows


# ------------------------------------------------------------- [multihost]


def multihost_layout():
    """(ranks, mesh positions a rank, the backend the rule must choose, a
    description, each rank's environment): one rank a card over NCCL where
    there are MESH_SHARDS cards, else two ranks sharing cuda:0 (two logical
    shards each) over gloo through host memory."""
    n = torch.cuda.device_count()
    if n >= MESH_SHARDS:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = vis.split(",") if vis else [str(i) for i in range(n)]
        return (MESH_SHARDS, 1, "nccl",
                f"{MESH_SHARDS} ranks, one card each",
                [{"CUDA_VISIBLE_DEVICES": ids[r]}
                 for r in range(MESH_SHARDS)])
    return (2, MESH_SHARDS // 2, "gloo",
            f"2 ranks sharing cuda:0, {MESH_SHARDS // 2} logical shards each",
            [{}, {}])


def _free_port() -> int:
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def phase_multihost(card, work, mesh_ref, dist_rows):
    """A mesh that spans query processes: ``multihost_layout()``'s workers
    (this script with ``--multihost-worker``) register in a meta store
    under ``work`` and join one process group through
    ``join_cluster_mesh``, MESH_SHARDS positions in all. Each rank: (a)
    [mesh]'s configuration 5 from only its own rows of the corpus [mesh]
    wrote (f32 ids equal to [mesh]'s and to the f64 truth, bf16 recall
    >= 0.95); (b) DIST_STATEMENTS with ``enable_distributed_execution`` on
    over the TPC-H data root [dist] used, each exchange called, rows alike
    ``dist_rows`` (``dist_same``). A worker that fails or outlives
    MULTIHOST_TIMEOUT fails the run."""
    import pickle
    ranks, per, want, how, envs = multihost_layout()
    meta = os.path.join(work, "cluster.db")
    if os.path.exists(meta):
        os.remove(meta)
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    print(f"[multihost] {how}: {ranks} workers, {per} positions each, the "
          f"rule must choose {want} [{card}]")
    t0 = time.perf_counter()
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if k != "DATABEND_TORCH_DEVICE"}
        env.update(envs[r])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-worker",
             work, str(_free_port()), str(ranks), str(per)],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            left = MULTIHOST_TIMEOUT - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        check(False, f"[multihost] a worker outlived {MULTIHOST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for out in outs:
        print("\n".join(line for line in out.splitlines()
                        if line.startswith("[multihost]")))
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"[multihost] worker {r} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    wall = time.perf_counter() - t0
    res = []
    for r in range(ranks):
        with open(os.path.join(work, f"multihost{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    x = np.load(os.path.join(work, "mesh_x.npy"), mmap_mode="r")
    q = np.load(os.path.join(work, "mesh_q.npy")).astype(np.float64)
    for r, got in enumerate(res):
        check(got["backend"] == want, f"[multihost] rank {r} took backend "
                                      f"{got['backend']}, the rule {want}")
        f32 = got["ids0"]
        check(np.array_equal(f32, mesh_ref["ids"])
              and np.array_equal(f32, mesh_ref["truth"]),
              f"[multihost] rank {r}: f32 ids differ from [mesh]'s or the "
              "f64 truth")
        bf = got["ids1"].astype(np.int64)
        d = ((x[bf.reshape(-1)].astype(np.float64).reshape(
            bf.shape + (-1,)) - q[:, None, :]) ** 2).sum(-1)
        rb = float((d <= mesh_ref["kth"][:, None]
                    + 1e-9 * np.abs(mesh_ref["kth"][:, None])).mean())
        check(rb >= 0.95, f"[multihost] rank {r}: bf16 recall {rb}")
        alike = {}
        for name, what, names, _ in DIST_STATEMENTS:
            took = got[f"calls_{name}"]
            check(all(took.get(n, 0) >= 2 for n in names),
                  f"[multihost] rank {r} {name}: {names} not called: {took}")
            alike[name] = dist_same(dist_rows[name], got[f"rows_{name}"])
            check(alike[name], f"[multihost] rank {r} {name}: rows differ "
                               "from the single-process [dist] rows")
        print(f"[multihost] rank {r}: backend {got['backend']} (the rule's "
              f"{want}), owners {got['owners']}; f32 ids equal to [mesh]'s "
              f"and the f64 truth: True, bf16 recall@10 {rb}; [dist] rows "
              f"alike the single-process rows: {alike} [{card}]")
    print(f"[multihost] {ranks} workers done in {wall:.1f} s (start to "
          f"exit, process start and data reads included) [{card}]")


def multihost_worker(work, port, ranks, per):
    """One query process of [multihost] (``--multihost-worker WORK PORT
    RANKS POSITIONS``): registers in ``WORK/cluster.db``, joins the mesh,
    runs (a) and (b) of ``phase_multihost`` and writes what it read to
    ``WORK/multihost<rank>.pkl``."""
    import pickle
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from databend_tpu_torch import parallel
    from databend_tpu_torch.meta.cluster import ClusterDiscovery
    from databend_tpu_torch.meta.kv import MetaStore
    from databend_tpu_torch.parallel import mesh as pm
    from databend_tpu_torch.parallel import multihost
    from databend_tpu_torch.service.session import SessionContext
    from databend_tpu_torch.utils.metrics import METRICS

    card = card_line()
    meta = MetaStore(os.path.join(work, "cluster.db"))
    node = ClusterDiscovery.local_node(address=f"localhost:{port}")
    ClusterDiscovery(meta).register(node)
    t0 = time.perf_counter()
    mesh, rank = multihost.join_cluster_mesh(
        meta, node.node_id, ranks, timeout=MULTIHOST_GROUP_TIMEOUT,
        local_device_count=per)
    tag = f"[multihost] rank {rank}"
    mine = mesh.local_positions()
    devs = sorted({mesh.devices[i, j] for i, j in mine}, key=str)
    print(f"{tag}: joined in {time.perf_counter() - t0:.1f} s; backend "
          f"{mesh.backend}, owners {mesh.owners.tolist()}, its positions "
          f"{[j for _, j in mine]} on {[str(d) for d in devs]} "
          f"(node {node.node_id}) [{card}]", flush=True)
    out = {"backend": mesh.backend, "owners": mesh.owners.tolist()}

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    def collectives():
        snap = METRICS.snapshot()
        return (snap.get("mesh_collectives", 0.0),
                snap.get("mesh_collective_seconds", 0.0))

    # (a) configuration 5: this rank reads and uploads only its own rows
    rows = MESH_ROWS // MESH_SHARDS
    cols = [j for _, j in mine]
    t0 = time.perf_counter()
    x = np.load(os.path.join(work, "mesh_x.npy"), mmap_mode="r")
    local = np.ascontiguousarray(x[cols[0] * rows:(cols[-1] + 1) * rows])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_dev = pm.from_process_local(mesh, pm.P(pm.SHARD_AXIS, None), local)
    sync()
    upload_s = time.perf_counter() - t0
    del local, x
    q = np.load(os.path.join(work, "mesh_q.npy"))
    q_dev = pm.put_sharded(q, mesh, pm.P(pm.DP_AXIS, None))

    def run(bf16):
        dv, iv = parallel.sharded_brute_force_topk(
            mesh, q_dev, x_dev, K, "l2", bf16=bf16, n_valid=MESH_ROWS)
        return np.asarray(dv), np.asarray(iv)

    for bf16 in (False, True):
        t0 = time.perf_counter()
        _, iv = run(bf16)
        first = (time.perf_counter() - t0) * 1e3
        stats = collectives()
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(bf16)
            warm.append((time.perf_counter() - t0) * 1e3)
        coll_n, coll_s = np.subtract(collectives(), stats) / 3
        coll_ms = coll_s * 1e3
        out[f"ids{int(bf16)}"] = iv
        print(f"{tag}: {'bf16' if bf16 else 'f32'} B={MESH_B} k={K} over "
              f"{len(cols)} x {rows} own rows (read {read_s:.2f} s, upload "
              f"{upload_s:.2f} s): first batch {first:.1f} ms, warm "
              f"{float(np.median(warm)):.1f} ms (median of 3), collectives "
              f"{coll_ms:.3f} ms in {coll_n:.0f} calls a batch [{card}]",
              flush=True)
    # NCCL's kernels wait on the card for the slowest rank, on a stream of
    # their own: their time is not work, and it overlaps the scans'
    whole, busy = device_busy(lambda: run(False), skip="nccl")
    print(f"{tag}: a whole f32 batch {whole:.3f} ms, device busy {busy:.3f} "
          f"ms (this rank's kernels and copies but NCCL's), idle share "
          f"{100 * (1 - busy / whole):.0f}% [{card}]", flush=True)
    del x_dev

    # (b) the [dist] statements on the shared TPC-H data root
    calls = {}
    restore = spy_exchanges(calls)
    t0 = time.perf_counter()
    ctx = SessionContext(os.path.join(work, "tpch"))
    ctx.sql("SET enable_device_local_execution = 0")
    ctx.sql("SET enable_distributed_execution = 1")
    try:
        for name, what, _, sql in DIST_STATEMENTS:
            calls.clear()
            t1 = time.perf_counter()
            ctx.sql(sql)
            sync()
            first = (time.perf_counter() - t1) * 1e3
            stats = collectives()
            t1 = time.perf_counter()
            res = ctx.sql(sql)
            sync()
            warm = (time.perf_counter() - t1) * 1e3
            coll_ms = (collectives()[1] - stats[1]) * 1e3
            out[f"rows_{name}"] = res.block
            out[f"calls_{name}"] = dict(calls)
            print(f"{tag}: {name} ({what}, {res.block.num_rows} rows): first "
                  f"{first:.1f} ms, warm {warm:.1f} ms, collectives "
                  f"{coll_ms:.1f} ms of it; calls {dict(calls)} [{card}]",
                  flush=True)
    finally:
        restore()
        ctx.close()
    print(f"{tag}: the statements took {time.perf_counter() - t0:.1f} s "
          f"with the session's open [{card}]", flush=True)
    with open(os.path.join(work, f"multihost{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    multihost.leave_cluster_mesh()
    return 0


def multihost_alone(card):
    """``--multihost``: [multihost] alone, with what it compares against
    made first: TPC-H SF1 loaded and [dist] run in one process, then
    [mesh]."""
    import databend_tpu_torch as dt
    from benchmarks.tpch import generate
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        ctx = dt.SessionContext(os.path.join(work, "tpch"))
        load_tpch_tables(ctx, generate(AGG_SF, seed=AGG_SEED))
        print(f"[multihost] TPC-H sf {AGG_SF} generated and loaded: "
              f"{time.perf_counter() - t0:.1f} s (host)")
        try:
            dist_rows = phase_dist(card, ctx, False)
        finally:
            ctx.close()
        mesh_ref = phase_mesh(card, work)
        phase_multihost(card, work, mesh_ref, dist_rows)


# ------------------------------------------------------------------- [agg]


def grouped_sums_bound(n, k, groups):
    """(ms, "bytes" or "operations"): one read of gid and the [K, n] rows
    plus one write of the [K, G + 1] int32 sums at the memory rate, or one
    int32 add per (row, value row) at the int32 instruction rate, whichever
    is larger."""
    t_bytes = 4 * (n + k * n + k * (groups + 1)) / HBM_BYTES_PER_S * 1e3
    t_ops = k * n / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gs_plan(n, k, groups):
    """The plan's launches on this card for n rows, k value rows and G, and
    their placements as text."""
    from databend_tpu_torch.ops import grouped_sums as gs
    plan = gs._device_plan(torch.cuda.current_device(), n, k, groups)
    return plan, " + ".join(
        f"{l.placement} C={l.cluster} S={l.slices} R={l.rows} W={l.width} "
        f"T={l.threads} blocks={l.blocks}" for l in plan)


def hold_grouped_sums(card, what, gid, rows, groups, repeats=0):
    """One call of grouped_sums (one launch a batch of value rows of its
    plan) against its plain version on the same tensors (bit-equal: integer
    sums), ``repeats`` more calls that must give the same bits, then the
    kernel, the plain version and the library call (one ``index_add_`` into
    int32 from a [K, n] block, stacked before the timing when ``rows`` is a
    list) timed beside the bound. Returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms, placement)."""
    from databend_tpu_torch.ops.grouped_sums import (
        _grouped_sums_plain, grouped_sums)
    k = len(rows)
    n = gid.shape[0]
    plan, placement = gs_plan(n, k, groups)
    before = grouped_sums.launches
    got = grouped_sums(gid, rows, groups)
    torch.cuda.synchronize()
    check(grouped_sums.launches == before + len(plan),
          f"{what}: {grouped_sums.launches - before} launches, want "
          f"{len(plan)}")
    want = _grouped_sums_plain(gid, rows, groups)
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    check(err == 0, f"grouped_sums vs plain {what}: max abs err {err}")
    for i in range(repeats):
        again = grouped_sums(gid, rows, groups)
        check(torch.equal(again, got), f"{what}: launch {i + 2} differs from "
                                       "the first")
    block = rows if isinstance(rows, torch.Tensor) else torch.stack(rows)

    def library():
        return torch.zeros((k, groups + 1), dtype=torch.int32,
                           device=gid.device).index_add_(1, gid, block)

    check(torch.equal(library(), want), f"{what}: index_add_ differs")
    del got, want
    ms = cuda_ms(lambda: grouped_sums(gid, rows, groups))
    plain_ms = cuda_ms(lambda: _grouped_sums_plain(gid, rows, groups))
    library_ms = cuda_ms(library)
    del block
    bound_ms, bound_by = grouped_sums_bound(n, k, groups)
    print(f"[kernel] grouped_sums {what} ({placement}): max_abs_err {err}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.0f}% reached)"
          f"{f', {repeats} repeats bit-equal' if repeats else ''} [{card}]")
    return err, ms, plain_ms, bound_ms, bound_by, library_ms, placement


def hold_list_form(card, what, gid, rows, groups):
    """The value rows as K tensors of their own (the route's form) give the
    bits of the stacked [K, n] form."""
    from databend_tpu_torch.ops.grouped_sums import grouped_sums
    parts = [r.clone() for r in rows]
    same = torch.equal(grouped_sums(gid, parts, groups),
                       grouped_sums(gid, rows, groups))
    print(f"[kernel] grouped_sums {what}: K separate rows equal the stacked "
          f"block: {same} [{card}]")
    check(same, f"grouped_sums {what}: the list form differs")


GS_GROUPS = (1, 12, 64, 10_001, 65_536, 200_000)


def phase_grouped_sums_kernel(card):
    """grouped_sums at the route's sizes: n of 6M (TPC-H SF1 lineitem) and
    8M (one full chunk), K of 6 and 20 value rows, G of 1, 12, 64 (the mask
    engine), 10,001 and 65,536 (the matmul engine, up to its largest grid)
    and 200,000 (a grid past a cluster of two, which the plan keeps in out:
    the route gives it only under raised group caps); ids uniform over [0, G], values in [-255, 255] (a limb's range). The
    list form against the stacked form at the first shape of each
    placement; 300 repeats at Q1's shape and at the first shape the plan
    spreads over a cluster. Then 65 value rows (two launches: more than one
    launch's row pointers) and every row in one group (the most
    contention)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results, listed, cluster_repeated = {}, set(), False
    for n in (6_000_000, 8_000_000):
        for k in (6, 20):
            rows = torch.randint(-255, 256, (k, n), generator=g,
                                 device="cuda", dtype=torch.int32)
            for groups in GS_GROUPS:
                gid = torch.randint(0, groups + 1, (n,), generator=g,
                                    device="cuda", dtype=torch.int32)
                plan, _ = gs_plan(n, k, groups)
                repeats = 0
                if (n, k, groups) == (6_000_000, 20, 12):
                    repeats = 300
                elif not cluster_repeated and any(l.cluster > 1
                                                  for l in plan):
                    repeats, cluster_repeated = 300, True
                what = f"n={n} K={k} G={groups}"
                results[(n, k, groups)] = hold_grouped_sums(
                    card, what, gid, rows, groups, repeats=repeats)
                kinds = tuple((l.placement, l.cluster > 1) for l in plan)
                if kinds not in listed:
                    listed.add(kinds)
                    hold_list_form(card, what, gid, rows, groups)
            del rows
    check(cluster_repeated, "no sweep shape spread over a cluster")
    n, k, groups = 1_000_000, 65, 10_001
    rows = [torch.randint(-255, 256, (n,), generator=g, device="cuda",
                          dtype=torch.int32) for _ in range(k)]
    gid = torch.randint(0, groups + 1, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    results["65 rows"] = hold_grouped_sums(
        card, f"n={n} K={k} G={groups} (list)", gid, rows, groups)
    n, k = 6_000_000, 20
    rows = torch.randint(-255, 256, (k, n), generator=g, device="cuda",
                         dtype=torch.int32)
    gid = torch.zeros(n, dtype=torch.int32, device="cuda")
    results["one group"] = hold_grouped_sums(
        card, f"n={n} K={k} G=12, every row in group 0", gid, rows, 12)
    del rows, gid
    torch.cuda.empty_cache()
    return results


GS_DIAGNOSE_CLUSTERS = (1, 2, 4, 8)   # every cluster size the kernel takes


def diagnose_grouped_sums(card):
    """grouped_sums at n = 6M, K of 6 and 20 value rows (the list form):
    every placement the kernel can take (``_placement`` for each cluster
    size and blocks an SM, and the grid in out, ``_global_placement``) at G
    of 12, 10,001, 65,536 (the matmul engine's largest grid), 200,000 and
    400,000 (past a cluster of two: only under raised group caps), each
    bit-equal to the plain version, then timed in turn, the plan's choice
    marked."""
    from databend_tpu_torch.ops import grouped_sums as gs
    index = torch.cuda.current_device()
    occupancy = functools.partial(gs._occupancy, index)
    stream = torch.cuda.current_stream().cuda_stream
    lib = gs._launcher()
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n = 6_000_000
    for k in (6, 20):
        rows = [torch.randint(-255, 256, (n,), generator=g, device="cuda",
                              dtype=torch.int32) for _ in range(k)]
        for groups in (12, 10_001, 65_536, 200_000, 400_000):
            gid = torch.randint(0, groups + 1, (n,), generator=g,
                                device="cuda", dtype=torch.int32)
            want = gs._grouped_sums_plain(gid, rows, groups)
            out = torch.zeros_like(want)
            chosen = gs._device_plan(index, n, k, groups)[0]
            launches = [gs._placement(n, 0, k, groups, cluster, per_sm,
                                      occupancy)
                        for cluster in GS_DIAGNOSE_CLUSTERS
                        for per_sm in gs.BLOCKS_PER_SM]
            launches.append(gs._global_placement(n, 0, k, groups, occupancy))

            def run(launch, gid=gid, rows=rows, out=out):
                out.zero_()
                gs._launch(lib, gid, rows, out, launch, stream)

            for launch in filter(None, launches):
                run(launch)
                torch.cuda.synchronize()
                check(torch.equal(out, want),
                      f"--diagnose: {launch} differs from the plain version")
                ms = cuda_ms(lambda: run(launch), 10)
                mark = " (the plan)" if launch == chosen else ""
                print(f"[diagnose] grouped_sums n={n} K={k} G={groups}: "
                      f"{launch.placement} C={launch.cluster} "
                      f"S={launch.slices} R={launch.rows} W={launch.width} "
                      f"T={launch.threads} blocks={launch.blocks}: "
                      f"{ms:.4f} ms{mark} [{card}]")
            del want, out, gid
        del rows
    torch.cuda.empty_cache()


def string_column(arr):
    """A String column from a numpy array of ASCII str, built without a
    Python list of millions of strings."""
    from databend_tpu_torch.expression import Column
    from databend_tpu_torch.expression.column import StringData
    from databend_tpu_torch.types import String
    fixed = np.ascontiguousarray(arr.astype("S"))
    raw = np.frombuffer(fixed.tobytes(), np.uint8).reshape(
        len(fixed), fixed.dtype.itemsize)
    used = raw != 0              # NUL pads the fixed width, never a value
    offsets = np.zeros(len(fixed) + 1, np.int64)
    np.cumsum(used.sum(1), out=offsets[1:])
    return Column(String, StringData(offsets, raw[used]))


def load_lineitem(ctx, cols):
    """``lineitem`` of benchmarks/tpch.py, typed as its ``load`` types it
    (that loader imports the JAX package)."""
    from benchmarks.tpch import DDL
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.types import Date, Float64, Int64
    ctx.sql(DDL["lineitem"])
    arrays = []
    for name, vals in cols.items():
        if name.endswith("date"):
            arrays.append(Column(Date, vals.astype(np.int32)))
        elif vals.dtype.kind == "f":
            arrays.append(Column(Float64, vals.astype(np.float64)))
        elif vals.dtype.kind in "iu":
            arrays.append(Column(Int64, vals.astype(np.int64)))
        else:
            arrays.append(string_column(vals))
    ctx.insert_block("lineitem", DataBlock(list(cols), arrays))


def agg_truth(li):
    """Q1's and Q6's rows from the generated arrays: integer sums in
    cents, turned into floats as the route's finish turns its exact totals
    (total / scale, an average then / count)."""
    cents = np.rint(li["l_extendedprice"] * 100).astype(np.int64)
    disc = np.rint(li["l_discount"] * 100).astype(np.int64)
    tax = np.rint(li["l_tax"] * 100).astype(np.int64)
    qty = li["l_quantity"].astype(np.int64)
    ship = li["l_shipdate"]

    def div(total, scale, count=None):
        out = np.array([total], np.int64) / scale
        return float(out[0] if count is None
                     else (out / np.array([count], np.int64))[0])

    q1 = []
    keep = ship <= 10471                                  # 1998-09-02
    for flag in ("A", "N", "R"):
        for status in ("F", "O"):
            m = keep & (li["l_returnflag"] == flag) \
                & (li["l_linestatus"] == status)
            c = int(m.sum())
            if not c:
                continue
            price = cents[m]
            q1.append((flag, status, div(qty[m].sum(), 1),
                       div(price.sum(), 100),
                       div((price * (100 - disc[m])).sum(), 10 ** 4),
                       div((price * (100 - disc[m]) * (100 + tax[m])).sum(),
                           10 ** 6),
                       div(qty[m].sum(), 1, c), div(price.sum(), 100, c),
                       div(disc[m].sum(), 100, c), c))
    m = (ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7) \
        & (qty < 24)                                   # 1994-01-01, 1995-01-01
    return q1, [(div((cents[m] * disc[m]).sum(), 10 ** 4),)]


def same_rows(want, got):
    """The reference route test's rule: integers and strings equal, floats
    within rel 1e-12 (exact limb sums against host f64 sums)."""
    if len(want) != len(got):
        return False
    for wr, gr in zip(want, got):
        if len(wr) != len(gr):
            return False
        for a, b in zip(wr, gr):
            if isinstance(a, float) and isinstance(b, float):
                if abs(a - b) > max(1e-12 * abs(a), 1e-9):
                    return False
            elif a != b:
                return False
    return True


def agg_statements():
    """(name, engine, SQL): TPC-H Q1 (12 groups) and Q6 (one) on the mask
    engine, a GROUP BY over 10,001 suppliers on the matmul engine, one over
    200,001 parts on the sort engine (a [K, G] pull under 16 MB), and a
    COUNT(DISTINCT) pair (4 groups, mask)."""
    from benchmarks.tpch import QUERIES
    return [
        ("q1", "mask", QUERIES["q1"]),
        ("q6", "mask", QUERIES["q6"]),
        ("by_supplier", "matmul",
         "SELECT l_suppkey, sum(l_extendedprice), sum(l_quantity), count(*) "
         "FROM lineitem GROUP BY l_suppkey"),
        ("by_part", "sort",
         "SELECT l_partkey, sum(l_quantity), count(*) FROM lineitem "
         "GROUP BY l_partkey"),
        ("distinct_suppliers", "mask",
         "SELECT l_returnflag, count(DISTINCT l_suppkey) FROM lineitem "
         "GROUP BY l_returnflag")]


def phase_agg(card, profile, root):
    """The device scan-aggregate route on TPC-H SF1 lineitem
    (benchmarks/tpch.py, 6,000,000 rows, seed 42): each statement of
    ``agg_statements()`` on the host (route off), then routed: the first call
    (builds and uploads the resident forms) and AGG_REPS warm calls. Each
    routed run must count one routed query and no route error, take the
    named engine, and return the host's rows; Q1 and Q6 also a numpy
    computation in integer cents. Then Q1 once more with CHUNK_ROWS at
    AGG_CHUNK_ROWS (4 chunks combined on the host).
    Then [tpch] (``phase_tpch``) and [dist] (``phase_dist``) in the same
    context, over this lineitem, its data under ``root``. Returns the
    grouped_sums launches of the [agg] statements, the kernel's inputs of
    each statement's first routed call, the [tpch] launches and [dist]'s
    result blocks."""
    import types as pytypes
    import databend_tpu_torch as dt
    from benchmarks.tpch import generate
    from databend_tpu_torch.ops import grouped_sums as gs
    from databend_tpu_torch.pipeline import device_scan_agg as dsa
    from databend_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    data = generate(AGG_SF, seed=AGG_SEED)
    li = data["lineitem"]
    n = len(li["l_orderkey"])
    q1_truth, q6_truth = agg_truth(li)
    print(f"[agg] TPC-H sf {AGG_SF} lineitem: {n} rows + numpy Q1 / Q6 in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    def counts():
        snap = METRICS.snapshot()
        return (snap.get("device_scan_agg_queries", 0),
                snap.get("device_scan_agg_errors", 0))

    captured, engines = {}, []
    state = {"statement": None}
    real_program = dsa._build_program

    def program_spy(ir):
        engines.append(ir[4])
        return real_program(ir)

    def sums_spy(gid, rows, groups):
        captured.setdefault(state["statement"], (gid, rows, groups))
        return gs.grouped_sums(gid, rows, groups)

    def routed(sql):
        before = counts()
        rows = ctx.sql(sql).rows()
        torch.cuda.synchronize()
        after = counts()
        check(after == (before[0] + 1, before[1]),
              f"[agg] route counts {before} -> {after} for: {sql}")
        return rows

    ctx = dt.SessionContext(root)
    for name, value in AGG_CAPS.items():
        ctx.sql(f"SET {name} = {value}")
    print(f"[agg] group caps set for [agg] and [tpch]: {AGG_CAPS}")
    real_gsums = dsa.gsums
    dsa._build_program = program_spy
    dsa.gsums = pytypes.SimpleNamespace(grouped_sums=sums_spy)
    try:
        t0 = time.perf_counter()
        load_lineitem(ctx, li)
        print(f"[agg] create + insert lineitem: "
              f"{time.perf_counter() - t0:.1f} s")
        table = ctx.table("lineitem")
        snap_id = table.read_snapshot().snapshot_id
        results = {}
        gs.grouped_sums.launches = 0
        statements = agg_statements()
        for name, engine, sql in statements:
            state["statement"] = name
            ctx.sql("SET enable_device_local_execution = 0")
            t0 = time.perf_counter()
            host = ctx.sql(sql).rows()
            host_s = time.perf_counter() - t0
            ctx.sql("SET enable_device_local_execution = 1")
            engines.clear()
            t0 = time.perf_counter()
            first = routed(sql)
            first_s = time.perf_counter() - t0
            resident = dsa.get_table_columns(table, snap_id).nbytes
            warm = []
            for _ in range(AGG_REPS):
                t0 = time.perf_counter()
                again = routed(sql)
                warm.append(time.perf_counter() - t0)
                check(again == first, f"[agg] {name}: a warm call "
                                      "differs from the first")
            check(engines[:1] == [engine],
                  f"[agg] {name}: engine {engines[:1]}, want {engine}")
            check(same_rows(sorted(host), sorted(first)),
                  f"[agg] {name}: routed rows differ from the host's: "
                  f"{host[:3]} vs {first[:3]}")
            if name == "q1":
                check(first == q1_truth, f"[agg] q1 differs from numpy: "
                                         f"{first} vs {q1_truth}")
            if name == "q6":
                check(first == q6_truth, f"[agg] q6 differs from numpy: "
                                         f"{first} vs {q6_truth}")
            results[name] = first
            print(f"[agg] {name} ({engine}, {len(first)} rows): host "
                  f"{host_s * 1e3:.1f} ms, first routed call "
                  f"{first_s * 1e3:.1f} ms (resident forms "
                  f"{resident / 2 ** 20:.1f} MiB), warm routed "
                  f"{float(np.median(warm)) * 1e3:.3f} ms (median of "
                  f"{AGG_REPS}; {min(warm) * 1e3:.3f}-"
                  f"{max(warm) * 1e3:.3f}) [{card}]")
        launches = gs.grouped_sums.launches
        want = sum(AGG_REPS + 1 for _, e, _ in statements
                   if e != "sort")
        print(f"[agg] grouped_sums launches over the statements: "
              f"{launches} (one per routed mask / matmul / distinct "
              f"call: {want}) [{card}]")
        check(launches == want, f"[agg] {launches} launches, want {want}")

        # Q1 in AGG_CHUNK_ROWS chunks: new resident forms, chunk sums
        # combined on the host
        saved = dsa.CHUNK_ROWS
        dsa._cache().clear()
        dsa.CHUNK_ROWS = AGG_CHUNK_ROWS
        try:
            state["statement"] = "q1 chunked"
            t0 = time.perf_counter()
            chunked = routed(statements[0][2])
            n_chunks = len(dsa.get_table_columns(table, snap_id)
                           .cols["l_shipdate"]["codes"])
            print(f"[agg] q1 in {n_chunks} chunks of {AGG_CHUNK_ROWS} "
                  f"rows: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
                  f"rows equal: {chunked == results['q1']} [{card}]")
            check(n_chunks == -(-n // AGG_CHUNK_ROWS),
                  f"[agg] {n_chunks} chunks")
            check(chunked == results["q1"],
                  "[agg] the chunked q1 differs from the one-chunk q1")
        finally:
            dsa.CHUNK_ROWS = saved
            dsa._cache().clear()
        if profile:
            for name, _, sql in statements:
                profile_call(f"[agg] {name} warm routed call", card,
                             lambda r, sql=sql: ctx.sql(sql).rows())
        tpch_launches = phase_tpch(card, profile, ctx, data, engines,
                                   state)
        dist_rows = phase_dist(card, ctx, profile)
        return launches, captured, tpch_launches, dist_rows
    finally:
        dsa._build_program = real_program
        dsa.gsums = real_gsums
        ctx.close()


def load_tpch_tables(ctx, data, skip=()):
    """The tables of benchmarks/tpch.py, typed and analyzed as its ``load``
    does (that loader imports the JAX package)."""
    from benchmarks.tpch import DDL
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.types import Date, Float64, Int64
    money = ("c_acctbal", "s_acctbal", "o_totalprice", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "ps_supplycost")
    for tname, cols in data.items():
        if tname in skip:
            continue
        ctx.sql(DDL[tname])
        arrays = []
        for name, vals in cols.items():
            if name.endswith("date"):
                arrays.append(Column(Date, vals.astype(np.int32)))
            elif name in money:
                arrays.append(Column(Float64, vals.astype(np.float64)))
            elif vals.dtype.kind in "iu":
                arrays.append(Column(Int64, vals.astype(np.int64)))
            else:
                arrays.append(string_column(vals))
        ctx.insert_block(tname, DataBlock(list(cols), arrays))
    for tname in data:
        ctx.sql(f"ANALYZE TABLE {tname}")


def phase_tpch(card, profile, ctx, data, engines, state):
    """The join-aggregate route and the finalize fusion on TPC-H SF1: the
    other seven tables of ``generate(AGG_SF, seed=AGG_SEED)`` loaded beside
    [agg]'s lineitem (2.66M rows more, nothing cut), every table analyzed,
    route defaults on but [agg]'s AGG_CAPS. Each of TPCH_QUERIES on the host (route off), then
    routed: the first call and TPCH_REPS warm calls. Each routed call must
    count no route error, return the host's rows (sorted, floats within rel
    1e-12) and pass ``benchmarks.tpch.check`` against the pandas
    ``expected``. Printed per statement: the routes that engaged (J1
    enrichment, J2 pushdown, the fusion, a plain scan-aggregate), the
    engines, any ``_Bail`` reason (a decline at this size fails nothing),
    grouped_sums launches. Returns the phase's grouped_sums launches."""
    from benchmarks import tpch
    from databend_tpu_torch.ops import grouped_sums as gs
    from databend_tpu_torch.pipeline import device_fusion as dfu
    from databend_tpu_torch.pipeline import device_join_agg as dja
    from databend_tpu_torch.pipeline import device_scan_agg as dsa
    from databend_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    load_tpch_tables(ctx, data, skip=("lineitem",))
    rows_more = sum(len(next(iter(c.values()))) for t, c in data.items()
                    if t != "lineitem")
    print(f"[tpch] create + insert the other seven tables ({rows_more} rows)"
          f" and analyze all eight: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frames = tpch.frames(data)
    expected = {q: tpch.expected(frames, q) for q in TPCH_QUERIES}
    del frames
    print(f"[tpch] pandas expected rows: {time.perf_counter() - t0:.1f} s "
          "(host)")

    routes, bails = [], []
    real = (dja._route_enrichment, dja._route_agg_pushdown, dfu.run_fusion,
            dsa._prepare)

    def host_half(name, fn):
        def spy(*a, **k):
            try:
                run = fn(*a, **k)
            except dsa._Bail as e:
                bails.append(f"{name}: {e}")
                raise
            return lambda: routes.append(name) or run()
        return spy

    def fusion_spy(*a):
        routes.append("fusion")
        return real[2](*a)

    def counts():
        snap = METRICS.snapshot()
        return tuple(snap.get(k, 0) for k in (
            "device_scan_agg_queries", "device_join_agg_queries",
            "device_scan_agg_errors", "device_join_agg_errors"))

    dja._route_enrichment = host_half("J1", real[0])
    dja._route_agg_pushdown = host_half("J2", real[1])
    dfu.run_fusion = fusion_spy
    dsa._prepare = host_half("scan-agg", real[3])
    total = 0
    try:
        for q in TPCH_QUERIES:
            sql = tpch.QUERIES[q]
            state["statement"] = f"tpch {q}"
            ctx.sql("SET enable_device_local_execution = 0")
            t0 = time.perf_counter()
            host = ctx.sql(sql).rows()
            host_s = time.perf_counter() - t0
            check(tpch.check(q, host, expected[q]),
                  f"[tpch] {q}: the host route differs from tpch.expected")
            ctx.sql("SET enable_device_local_execution = 1")
            routes.clear()
            bails.clear()
            engines.clear()
            gs.grouped_sums.launches = 0
            before = counts()
            t0 = time.perf_counter()
            first = ctx.sql(sql).rows()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            after = counts()
            took = (sorted(set(routes)), sorted(set(engines)), list(bails))
            warm = []
            for _ in range(TPCH_REPS):
                t0 = time.perf_counter()
                again = ctx.sql(sql).rows()
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(again == first, f"[tpch] {q}: a warm call differs "
                                      "from the first")
            launches = gs.grouped_sums.launches
            total += launches
            errors = counts()[2:]
            check(errors == before[2:],
                  f"[tpch] {q}: route errors {before[2:]} -> {errors}")
            check(same_rows(sorted(host), sorted(first)),
                  f"[tpch] {q}: routed rows differ from the host's: "
                  f"{host[:3]} vs {first[:3]}")
            check(tpch.check(q, first, expected[q]),
                  f"[tpch] {q}: routed rows differ from tpch.expected")
            print(f"[tpch] {q} ({len(first)} rows, equal to the host's and "
                  f"tpch.expected): host {host_s * 1e3:.1f} ms, first routed "
                  f"{first_s * 1e3:.1f} ms, warm routed "
                  f"{float(np.median(warm)) * 1e3:.1f} ms (median of "
                  f"{TPCH_REPS}); routes {took[0] or 'none'}, engines "
                  f"{took[1] or 'none'}, scan-agg / join-agg queries "
                  f"+{after[0] - before[0]:g} / +{after[1] - before[1]:g}, "
                  f"errors +0, grouped_sums launches {launches}; declined: "
                  f"{took[2] or 'nothing'} [{card}]")
            if profile:
                profile_call(f"[tpch] {q} warm routed call", card,
                             lambda r, sql=sql: ctx.sql(sql).rows())
    finally:
        (dja._route_enrichment, dja._route_agg_pushdown, dfu.run_fusion,
         dsa._prepare) = real
    print(f"[tpch] grouped_sums launches over the statements: {total} "
          f"[{card}]")
    return total


def hold_grouped_sums_agg(card, captured):
    """grouped_sums on the very inputs [agg] gave it (the first routed call
    of each statement)."""
    results = {}
    for name, (gid, rows, groups) in captured.items():
        k, n = len(rows), gid.shape[0]
        results[name] = hold_grouped_sums(
            card, f"[agg] {name}: n={n} K={k} G={groups}", gid, rows, groups)
    return results


def phase_suites(card):
    """The index sqllogictest suite through the port's entry point, on the
    card (no device override in its environment)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "DATABEND_TORCH_DEVICE"}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "databend_tpu_torch", "sqllogic",
             os.path.join("tests", "suites", "index"), "--data-root", root],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print(f"[suites] python -m databend_tpu_torch sqllogic tests/suites/index: "
          f"exit {proc.returncode}, {lines[-1] if lines else ''!r}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(proc.returncode == 0,
          f"sqllogic failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")


def check_standalone():
    """Every loaded port module comes from the port's own directory; no
    jax, jaxlib or databend_tpu module was loaded."""
    port = os.path.realpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "databend_tpu_torch"))
    mods = {m: getattr(mod, "__file__", None)
            for m, mod in list(sys.modules.items())
            if m.split(".")[0] == "databend_tpu_torch"}
    strays = sorted(m for m, f in mods.items()
                    if f and not os.path.realpath(f).startswith(port + os.sep))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "databend_tpu"))
    print(f"[standalone] {len(mods)} port modules loaded, all from {port}: "
          f"{not strays}; jax / databend_tpu modules loaded: {leaked}")
    check(not strays, f"port modules from elsewhere: {strays}")
    check("databend_tpu_torch.index.inverted.device" in mods
          and "databend_tpu_torch.ops.impact_bm25" in mods,
          "the device BM25 modules were not loaded")
    check("databend_tpu_torch.index.hnsw.build" in mods
          and "databend_tpu_torch.index.hnsw.search" in mods,
          "the HNSW modules were not loaded")
    check("databend_tpu_torch.pipeline.device_scan_agg" in mods
          and "databend_tpu_torch.ops.grouped_sums" in mods,
          "the scan-aggregate modules were not loaded")
    check(all(f"databend_tpu_torch.{m}" in mods for m in (
        "parallel.mesh", "parallel.distributed", "parallel.exchange",
        "parallel.fragmenter", "ops.quantization")),
          "the mesh, exchange or SQ-u8 modules were not loaded")
    check("databend_tpu_torch._reference" not in mods,
          "databend_tpu_torch._reference is loaded")
    check(not leaked, f"reference modules loaded: {leaked}")


def _device_us(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    return float(us if us is not None else ev.self_cuda_time_total)


def _kernels(events):
    """The profiler's device-side events: kernels and copies. An aten op's
    own device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA]


def profile_call(what, card, call, reps=3):
    """torch.profiler over ``reps`` calls of ``call(r)`` after a warm-up:
    whole-call ms (host clock), device-busy ms (the summed time of the
    profiler's device-side events), idle share and the biggest device items,
    per call."""
    from torch.profiler import ProfilerActivity, profile
    call(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(reps):
            call(r)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) / reps * 1e3
    events = _kernels(prof.key_averages())
    busy = sum(_device_us(e) for e in events) / reps / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:8]
    items = "; ".join(f"{e.key[:60]} {_device_us(e) / reps / 1e3:.3f} ms"
                      for e in top if _device_us(e) > 0)
    print(f"[profile] {what}: whole call {whole:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {100 * (1 - busy / whole):.0f}%, "
          f"{sum(e.count for e in events) // reps} device items per call; "
          f"biggest: {items} [{card}]")
    check(busy > 0, "the profiler saw no device time")
    n_items = sum(e.count for e in events) // reps
    # where the host's time goes: cProfile (it slows the host, so read the
    # shares, not the sum), the port's functions by cumulative time
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for r in range(reps):
        call(r)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    port = sorted(((ct, fn, name) for (fn, _, name), (_, _, _, ct, _)
                   in stats.items() if "databend_tpu_torch" in fn),
                  reverse=True)[:12]
    print(f"[profile] {what}, host cumulative ms per call under cProfile: "
          + "; ".join(f"{os.path.basename(fn)}:{name} {ct / reps * 1e3:.2f}"
                      for ct, fn, name in port) + f" [{card}]")
    return whole, busy, n_items


def profile_modes(ctx, queries, card, reps=3):
    """Per execute_batch_block mode: whole-call ms (host clock), ms inside
    _KnnServer._topk (device work and its one fetch), device-busy ms (the
    summed time of the profiler's device-side events) and the biggest of
    them, per batch."""
    from torch.profiler import ProfilerActivity, profile
    from databend_tpu_torch.service import prepared

    real = prepared._KnnServer._topk
    topk_s = []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real(self, *a, **kw)
        finally:
            topk_s.append(time.perf_counter() - t0)

    sql = ("SELECT id, {fn}(emb, ?) AS d FROM t ORDER BY {fn}(emb, ?) LIMIT 10")
    sets = [(v, v) for v in queries]
    prepared._KnnServer._topk = timed
    try:
        for metric, exact in (("l2", True), ("l2", False), ("cosine", False)):
            bp = ctx.prepare(sql.format(fn=f"{metric}_distance"))
            bp.execute_batch_block(sets, exact=exact)          # warm
            topk_s.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    bp.execute_batch_block(sets, exact=exact)
                torch.cuda.synchronize()
                whole = (time.perf_counter() - t0) / reps
            events = _kernels(prof.key_averages())
            busy = sum(_device_us(e) for e in events) / reps / 1e3
            top = sorted(events, key=_device_us, reverse=True)[:6]
            items = "; ".join(f"{e.key[:60]} {_device_us(e) / reps / 1e3:.3f} ms"
                              for e in top if _device_us(e) > 0)
            print(f"[profile] block {metric} exact={exact} B={len(sets)}: "
                  f"whole call {whole * 1e3:.3f} ms, _topk "
                  f"{sum(topk_s) / len(topk_s) * 1e3:.3f} ms, device busy "
                  f"{busy:.3f} ms per batch; biggest device items: {items} "
                  f"[{card}]")
            check(busy > 0, "the profiler saw no device time")
    finally:
        prepared._KnnServer._topk = real


# ------------------------------------------------------------------ [gates]
#
# The route gates: the settings (and one class constant) that send a
# statement to a device route or keep it on the host. ``--gates`` sweeps each
# on the card; the default run prints the gates in force and checks one
# statement on each side of G1 and G7.

GATES_REPS = 7          # warm calls a side, in turns with the other sides
GATES_RUNS = 2          # the whole sweep, twice in one process
GATES_SF = (0.01, 0.02, 0.05, 0.1, 0.3, 1.0)   # G1: lineitem 60k ... 6M rows
GATES_SCREEN_SF = (0.1, 1.0)                   # G2: 600k and 6M rows
GATES_GROUP_ROWS = 6_000_000                   # G3 / G4: rows of the grid table
GATES_GROUPS = (12, 64, 512, 4_096, 10_001, 65_536, 200_001, 1 << 19,
                1_000_000, 1 << 21, 1 << 22)   # G3 / G4: grid sizes G
GATES_VEC_ROWS = (4_096, 16_384, 65_536, 262_144)   # G5: one block each
GATES_HNSW_BLOCKS = (65_536, 262_144, 1 << 20)      # G6: row_per_block
GATES_DOCS = (2_000, 5_000, 20_000, 100_000)        # G7: one block each
GATES_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "gates.json")   # --gates' record by default
# the JAX package's defaults, set on a TPU: the half-to-twice rule below
# compares each crossover on the card with these
TPU_DEFAULTS = {
    "device_scan_agg_min_rows": 300_000,
    "device_scan_agg_max_groups": 64,
    "device_scan_agg_max_groups_matmul": 65_536,
    "device_scan_agg_max_groups_sort": 1 << 22,
    "device_scan_agg_max_pull_mb": 16,
    "vector_host_scan_max_rows": 1 << 16,
    "vector_exact_scan_max_rows": 1 << 20,
    "DEVICE_MIN_DOCS": 20_000,
}


def gates_in_force():
    """The port's gate defaults: its settings and the served-text gate."""
    from databend_tpu_torch.service.prepared import _MatchServer
    from databend_tpu_torch.settings import DEFAULT_SETTINGS
    from databend_tpu_torch.storage.fuse import table as fuse_table
    out = {k: DEFAULT_SETTINGS[k].default for k in TPU_DEFAULTS
           if k in DEFAULT_SETTINGS}
    out["DEVICE_MIN_DOCS"] = _MatchServer.DEVICE_MIN_DOCS
    out["GRAPH_BUILD_MIN_ROWS"] = fuse_table.GRAPH_BUILD_MIN_ROWS
    return out


def round_default(x, like):
    """``x`` rounded to a round number: a power of two where the default
    ``like`` is one, else one significant digit."""
    x = max(int(x), 1)
    if like & (like - 1) == 0:
        return 1 << int(round(np.log2(x)))
    unit = 10 ** (len(str(x)) - 1)
    return int(round(x / unit)) * unit


def gate_rule(name, crossover):
    """(default, "kept" or "set"): the TPU default where the card's crossover
    lies within half to twice it, else the crossover rounded."""
    tpu = TPU_DEFAULTS[name]
    if tpu / 2 <= crossover <= 2 * tpu:
        return tpu, "kept"
    return round_default(crossover, tpu), "set"


def first_win(sizes, wins):
    """The smallest size at which ``wins(size)`` holds in every run; the
    largest size swept where it never does."""
    return next((s for s in sizes if wins(s)), sizes[-1])


def last_win(sizes, wins):
    """The largest size up to which ``wins`` holds at every size swept; the
    smallest size swept where it fails there already."""
    best = sizes[0]
    for s in sizes:
        if not wins(s):
            break
        best = s
    return best


def _gate_ms(call):
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def gate_turns(sides, reps=GATES_REPS):
    """Time the sides of one gate at one size. ``sides``: (name, setup, call,
    cold, took): ``setup()`` sets the side's settings (untimed), ``cold()``
    empties the caches its first call fills (None: nothing to empty),
    ``took()`` is called before and returns a check called after each call,
    which says whether the call took the side's route. Each side's first
    call, then ``reps`` rounds of one call a side in turns. Returns {name:
    {"first": ms, "warm": [ms], "median": ms, "took": bool}} and {name: the
    first call's result}."""
    out, first = {}, {}

    def one(side):
        _, setup, call, _, took = side
        setup()
        after = took()
        ms, res = _gate_ms(call)
        return ms, res, after()

    for side in sides:
        side[1]()
        if side[3] is not None:
            side[3]()
        ms, res, ok = one(side)
        out[side[0]] = {"first": ms, "warm": [], "took": ok}
        first[side[0]] = res
    for _ in range(reps):
        for side in sides:
            ms, _, ok = one(side)
            out[side[0]]["warm"].append(ms)
            out[side[0]]["took"] &= ok
    for v in out.values():
        v["median"] = float(np.median(v["warm"]))
    return out, first


def same_result(want, got):
    """Two statements' results: the same rows in any order (floats within rel
    1e-12, as ``same_rows``); large grids compared as numpy columns ordered
    by their first column."""
    a, b = want.block, got.block
    if a.num_rows != b.num_rows:
        return False
    if a.num_rows <= 100_000:
        return same_rows(sorted(want.rows()), sorted(got.rows()))
    ca = [np.asarray(c.numpy()) for _, c in a.items()]
    cb = [np.asarray(c.numpy()) for _, c in b.items()]
    ia = np.argsort(ca[0], kind="stable")
    ib = np.argsort(cb[0], kind="stable")
    return all(np.array_equal(x[ia], y[ib]) for x, y in zip(ca, cb))


def same_match(want, got):
    """Served and generic ``match()`` rows: the same ids in the same order,
    scores within rel 1e-4 (the two paths round a doc's f32 sum apart)."""
    return [r[0] for r in want] == [r[0] for r in got] and np.allclose(
        [r[1] for r in want], [r[1] for r in got], rtol=1e-4)


def set_all(ctx, **kv):
    def setup():
        for k, v in kv.items():
            ctx.sql(f"SET {k} = {v}")
    return setup


class GateSweep:
    """The sweep's record: every timing under gates[gate][size][run], each
    line printed as it is taken and the whole record rewritten to ``out``,
    so a cut run keeps what it measured."""

    def __init__(self, card, out=GATES_OUT):
        self.card = card
        self.out = out
        self.data = {"card": card, "gates": {}, "decisions": {}}
        self.faults = []

    def add(self, gate, size, run, what, timings, note=""):
        rec = self.data["gates"].setdefault(gate, {}).setdefault(
            str(size), {}).setdefault(what, {})
        rec[str(run)] = timings
        parts = []
        for side, t in timings.items():
            parts.append(f"{side} first {t['first']:.3f} warm "
                         f"{t['median']:.3f}" + ("" if t["took"] else
                                                 " (OFF ITS ROUTE)"))
            if not t["took"]:
                self.faults.append(f"{gate} {size} {what} run {run}: {side} "
                                   "did not take its route")
        print(f"[gates] {gate} {size} {what} run {run}: " + "; ".join(parts)
              + f" ms{note} [{self.card}]", flush=True)
        self.dump()

    def same(self, gate, size, what, want, got, side):
        if not same_result(want, got):
            self.faults.append(f"{gate} {size} {what}: {side}'s rows differ "
                               "from the host's")

    def dump(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
        with open(self.out, "w") as f:
            json.dump(self.data, f, indent=1)


def gate_route_counts():
    from databend_tpu_torch.utils.metrics import METRICS
    c = METRICS.counters
    return (c.get("device_scan_agg_queries", 0)
            + c.get("device_join_agg_queries", 0),
            c.get("device_scan_agg_errors", 0)
            + c.get("device_join_agg_errors", 0))


def took_route(routed, engines=None, engine=None):
    """A ``took`` for gate_turns: the call counted one routed statement (or
    none, for the host) and no route error; with ``engine``, the grouping
    program it built was that engine's."""
    def took():
        before = gate_route_counts()
        seen = len(engines) if engines is not None else 0

        def after():
            now = gate_route_counts()
            ok = now[1] == before[1] and (
                now[0] > before[0] if routed else now[0] == before[0])
            if ok and engine is not None:
                ok = engines[seen:] != [] and set(engines[seen:]) == {engine}
            return ok
        return after
    return took


def sweep_agg(sweep, run, tpch_ctxs, group_ctx, engines, pulls):
    """G1 (table size: five TPC-H statements, host against the route at the
    default caps), G2 (the work screen: two bare aggregates, host against the
    forced route) and G3 / G4 (every engine the caps allow against the host
    at each grid size; the pull of each routed call)."""
    from benchmarks.tpch import QUERIES
    from databend_tpu_torch.pipeline import device_scan_agg as dsa
    cold = dsa._cache().clear
    g1 = [("q1", QUERIES["q1"]), ("q6", QUERIES["q6"]),
          ("by_supplier", agg_statements()[2][2]),
          ("q3", QUERIES["q3"]), ("q10", QUERIES["q10"])]
    for sf, (rows, ctx) in tpch_ctxs.items():
        host = set_all(ctx, enable_device_local_execution=0)
        route = set_all(ctx, enable_device_local_execution=1,
                        device_scan_agg_min_rows=0)
        for name, sql in g1:
            t, res = gate_turns([
                ("host", host, lambda: ctx.sql(sql), None,
                 took_route(False)),
                ("route", route, lambda: ctx.sql(sql), cold,
                 took_route(True))])
            sweep.same("G1", rows, name, res["host"], res["route"], "route")
            sweep.add("G1", rows, run, name, t)
        if sf not in GATES_SCREEN_SF:
            continue
        for name, sql in (
                ("count_filter",
                 "SELECT count(*) FROM lineitem WHERE l_quantity < 24"),
                ("avg", "SELECT avg(l_extendedprice) FROM lineitem")):
            t, res = gate_turns([
                ("host", host, lambda: ctx.sql(sql), None,
                 took_route(False)),
                ("route", route, lambda: ctx.sql(sql), cold,
                 took_route(True))])
            sweep.same("G2", rows, name, res["host"], res["route"], "route")
            sweep.add("G2", rows, run, name, t)

    ctx = group_ctx
    host = set_all(ctx, enable_device_local_execution=0)
    forced = {
        "mask": dict(device_scan_agg_max_groups=1 << 20,
                     device_scan_agg_max_groups_matmul=0,
                     device_scan_agg_max_groups_sort=0),
        "matmul": dict(device_scan_agg_max_groups=0,
                       device_scan_agg_max_groups_matmul=1 << 24,
                       device_scan_agg_max_groups_sort=0),
        "sort": dict(device_scan_agg_max_groups=0,
                     device_scan_agg_max_groups_matmul=0,
                     device_scan_agg_max_groups_sort=1 << 24)}
    for G in GATES_GROUPS:
        for what, sql in (
                ("sum_count", f"SELECT k{G}, sum(q), count(*) FROM g "
                              f"GROUP BY k{G}"),
                ("min_max", f"SELECT k{G}, min(v), max(v) FROM g "
                            f"GROUP BY k{G}")):
            sides = [("host", host, lambda: ctx.sql(sql), None,
                      took_route(False))]
            for engine, caps in forced.items():
                if engine == "mask" and G > 1 << 20:
                    continue            # past the setting's range
                if engine == "matmul" and what == "min_max":
                    continue            # MIN / MAX have no sum form
                sides.append((engine, set_all(
                    ctx, enable_device_local_execution=1,
                    device_scan_agg_min_rows=0,
                    device_scan_agg_max_pull_mb=0, **caps),
                    lambda: ctx.sql(sql), cold,
                    took_route(True, engines, engine)))
            pulls.clear()
            t, res = gate_turns(sides)
            for side in t:
                if side != "host":
                    sweep.same("G3", G, what, res["host"], res[side], side)
            pull = dict(pulls)
            sweep.data.setdefault("pull_bytes", {}).setdefault(
                str(G), {})[what] = pull
            sweep.add("G3", G, run, what, t,
                      note=f"; pull bytes {pull}")


def sweep_vectors(sweep, run, vec_ctx, hnsw_ctx, hnsw_truth):
    """G5 (host numpy scan against the card, literal KNN with and without a
    WHERE) and G6 (exact scan against HNSW at ef = 40, by block size; ms
    and recall@10)."""
    from databend_tpu_torch.ops.exact_topk import exact_topk_select
    from databend_tpu_torch.storage.fuse.table import FuseTable
    from databend_tpu_torch.utils.cache import CacheManager
    from databend_tpu_torch.utils.metrics import METRICS
    cm = CacheManager.instance()

    def cold():
        cm.vector_columns.clear()
        cm.vector_indexes.clear()

    ctx, lit = vec_ctx
    for n in GATES_VEC_ROWS:
        for what, where in (("knn", ""), ("knn_where", "WHERE id % 3 = 0 ")):
            sql = (f"SELECT id FROM v{n} {where}ORDER BY "
                   f"l2_distance(emb, {lit}) LIMIT 10")

            def took(on_host):
                def took_():
                    before = FuseTable._host_block_scores.calls
                    return lambda: (FuseTable._host_block_scores.calls
                                    > before) == on_host
                return took_
            t, res = gate_turns([
                ("host", set_all(ctx, vector_host_scan_max_rows=1 << 40),
                 lambda: ctx.sql(sql), None, took(True)),
                ("card", set_all(ctx, vector_host_scan_max_rows=0),
                 lambda: ctx.sql(sql), cold, took(False))])
            sweep.same("G5", n, what, res["host"], res["card"], "card")
            sweep.add("G5", n, run, what, t)

    ctx, lits = hnsw_ctx
    d_cos, kth = hnsw_truth
    for block in GATES_HNSW_BLOCKS:
        sql = (f"SELECT id FROM h{block} ORDER BY cosine_distance(emb, {{}}) "
               "LIMIT 10")

        def took(mode):
            def took_():
                searches = METRICS.counters.get("hnsw_search_batches", 0)
                launches = exact_topk_select.launches
                if mode == "hnsw":
                    return lambda: METRICS.counters.get(
                        "hnsw_search_batches", 0) > searches
                return lambda: exact_topk_select.launches > launches \
                    and METRICS.counters.get("hnsw_search_batches",
                                             0) == searches
            return took_
        sides = [(mode, set_all(ctx, vector_search_mode=f"'{mode}'"),
                  lambda: ctx.sql(sql.format(lits[0])), cold, took(mode))
                 for mode in ("exact", "hnsw")]
        t, _ = gate_turns(sides)
        rec = {}
        for mode in ("exact", "hnsw"):
            sides[[s[0] for s in sides].index(mode)][1]()
            ids = np.array([[i for (i,) in ctx.sql(sql.format(q)).rows()]
                            for q in lits])
            rec[mode] = recall(ids, d_cos, kth)
        sweep.data.setdefault("recall", {})[f"{block} run {run}"] = rec
        sweep.add("G6", block, run, "knn", t,
                  note=f"; recall@10 exact {rec['exact']}, hnsw "
                       f"{rec['hnsw']} on {len(lits)} queries")


def sweep_text(sweep, run, text_ctxs, pool):
    """G7: prepared match() served (per-block device BM25) against the
    generic path, at B = 1 and B = 8, by table size."""
    from databend_tpu_torch.ops.impact_bm25 import impact_bm25_topk
    from databend_tpu_torch.utils.cache import CacheManager
    cm = CacheManager.instance()
    for n, ctx in text_ctxs.items():
        sql = (f"SELECT id, score() FROM d{n} WHERE match(body, ?) "
               "ORDER BY score() DESC LIMIT 10")
        served, generic = ctx.prepare(sql), ctx.prepare(sql)
        served._match.DEVICE_MIN_DOCS = 0
        generic._match.DEVICE_MIN_DOCS = 1 << 62

        def cold():
            cm.inverted_indexes.clear()
            served._match._snap_id = None

        def took(is_served):
            def took_():
                before = impact_bm25_topk.launches
                return lambda: (impact_bm25_topk.launches > before) \
                    == is_served
            return took_
        for what, call in (
                ("b1", lambda pm: pm.execute(pool[0])),
                ("b8", lambda pm: pm.execute_batch([(t,) for t in pool[:8]]))):
            t, res = gate_turns([
                ("generic", lambda: None, lambda: call(generic), None,
                 took(False)),
                ("served", lambda: None, lambda: call(served), cold,
                 took(True))])
            want = res["generic"] if what == "b8" else [res["generic"]]
            got = res["served"] if what == "b8" else [res["served"]]
            if not all(same_match(w.rows(), r.rows())
                       for w, r in zip(want, got)):
                sweep.faults.append(f"G7 {n} {what}: served rows differ "
                                    "from the generic path's")
            sweep.add("G7", n, run, what, t)


def gates_load(root, card):
    """Every table of the sweep, loaded once: TPC-H lineitem, orders,
    customer and nation at each of GATES_SF (a context each); the grid table
    ``g`` (GATES_GROUP_ROWS rows, a key column k<G> of exactly G - 1 values
    for each G of GATES_GROUPS, q in [1, 50], v in [0, 10,000)); vector tables
    v<n> (SIFT-shaped, seed 7, an l2 vector index, no graph); the [hnsw]
    corpus under graphs='always' at each of GATES_HNSW_BLOCKS rows a block;
    [match]'s texts at each of GATES_DOCS docs, one block each."""
    import databend_tpu_torch as dt
    from benchmarks.tpch import generate
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.types import Int64, String, VectorType

    t0 = time.perf_counter()
    tpch_ctxs = {}
    for sf in GATES_SF:
        data = generate(sf, seed=AGG_SEED)
        ctx = dt.SessionContext(os.path.join(root, f"tpch{sf}"))
        load_tpch_tables(ctx, {t: data[t] for t in
                               ("nation", "customer", "orders", "lineitem")})
        tpch_ctxs[sf] = (len(data["lineitem"]["l_orderkey"]), ctx)
        del data
    print(f"[gates] TPC-H at sf {GATES_SF}: lineitem "
          f"{[r for r, _ in tpch_ctxs.values()]} rows, loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rng = np.random.default_rng(AGG_SEED)
    n = GATES_GROUP_ROWS
    group_ctx = dt.SessionContext(os.path.join(root, "groups"))
    names = [f"k{G}" for G in GATES_GROUPS] + ["q", "v"]
    group_ctx.sql("CREATE TABLE g (" + ", ".join(f"{c} BIGINT"
                                                 for c in names) + ")")
    cols = [Column(Int64, (np.arange(n, dtype=np.int64) % (G - 1))[
        rng.permutation(n)]) for G in GATES_GROUPS]
    cols.append(Column(Int64, rng.integers(1, 51, n, dtype=np.int64)))
    cols.append(Column(Int64, rng.integers(0, 10 ** 4, n, dtype=np.int64)))
    group_ctx.insert_block("g", DataBlock(names, cols))
    del cols
    group_ctx.sql("ANALYZE TABLE g")
    print(f"[gates] grid table g: {n} rows, keys of G in {GATES_GROUPS}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    centers = rng.integers(0, 256, size=(1000, DIM)).astype(np.float32)
    x = sift_like(rng, max(GATES_VEC_ROWS), centers)
    lit = "[" + ",".join(str(int(v)) for v in sift_like(rng, 1, centers)[0]) \
        + "]"
    vec_ctx = dt.SessionContext(os.path.join(root, "vectors"))
    for rows in GATES_VEC_ROWS:
        vec_ctx.sql(f"CREATE TABLE v{rows} (id BIGINT, emb VECTOR({DIM}))")
        vec_ctx.sql(f"CREATE VECTOR INDEX vi{rows} ON v{rows}(emb) "
                    "distance='l2'")
        vec_ctx.insert_block(f"v{rows}", DataBlock(
            ["id", "emb"],
            [Column.from_numpy(np.arange(rows, dtype=np.int64)),
             Column.from_numpy(x[:rows], VectorType(DIM))]))
    del x

    rng = np.random.default_rng(HNSW_SEED)
    centers = rng.integers(0, 256, size=(HNSW_CENTERS, DIM)).astype(np.float32)
    x = sift_like(rng, HNSW_ROWS, centers)
    queries = sift_like(rng, N_GT, centers)
    hnsw_truth = ground_truth(x, queries, "cosine")
    lits = ["[" + ",".join(str(int(v)) for v in q) + "]" for q in queries]
    hnsw_ctx = dt.SessionContext(os.path.join(root, "hnsw"))
    for block in GATES_HNSW_BLOCKS:
        t1 = time.perf_counter()
        hnsw_ctx.sql(f"CREATE TABLE h{block} (id BIGINT, emb VECTOR({DIM})) "
                     f"ROW_PER_BLOCK='{block}'")
        hnsw_ctx.sql(f"CREATE VECTOR INDEX hv{block} ON h{block}(emb) "
                     f"distance='cosine' graphs='always' m='{HNSW_M}' "
                     f"ef_construct='{HNSW_EF_CONSTRUCT}'")
        hnsw_ctx.insert_block(f"h{block}", DataBlock(
            ["id", "emb"],
            [Column.from_numpy(np.arange(HNSW_ROWS, dtype=np.int64)),
             Column.from_numpy(x, VectorType(DIM))]))
        print(f"[gates] h{block}: {HNSW_ROWS} rows in blocks of {block} "
              f"with a graph each: {time.perf_counter() - t1:.1f} s "
              f"[{card}]", flush=True)
    del x

    rng = np.random.default_rng(MATCH_SEED)
    n = max(GATES_DOCS)
    words = np.array(MATCH_WORDS)[rng.integers(0, len(MATCH_WORDS), (n, 4))]
    n_words = rng.integers(2, 5, n)
    texts = [" ".join(words[i, :n_words[i]]) for i in range(n)]
    pool = [" ".join(rng.choice(MATCH_WORDS, 2, replace=False))
            for _ in range(8)]
    text_ctxs = {}
    for docs in GATES_DOCS:
        ctx = dt.SessionContext(os.path.join(root, f"text{docs}"))
        ctx.sql(f"CREATE TABLE d{docs} (id BIGINT, body VARCHAR)")
        ctx.sql(f"CREATE INVERTED INDEX di{docs} ON d{docs}(body)")
        ctx.insert_block(f"d{docs}", DataBlock(
            ["id", "body"],
            [Column.from_numpy(np.arange(docs, dtype=np.int64)),
             Column.from_pylist(texts[:docs], String)]))
        text_ctxs[docs] = ctx
    print(f"[gates] vector, HNSW and text tables: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return (tpch_ctxs, group_ctx, (vec_ctx, lit), (hnsw_ctx, lits),
            hnsw_truth, text_ctxs, pool)


def gates_decide(sweep):
    """Each gate's crossover on the card and the default the half-to-twice
    rule gives, printed as one [gates] line a gate."""
    g = sweep.data["gates"]
    runs = [str(r) for r in range(1, GATES_RUNS + 1)]
    force = gates_in_force()
    dec = sweep.data["decisions"]

    def med(gate, size, what, run, side):
        return g[gate][str(size)][what][run][side]["median"]

    def say(name, crossover, how):
        default, verdict = gate_rule(name, crossover)
        dec[name] = {"crossover": crossover, "tpu": TPU_DEFAULTS[name],
                     "card": default, "verdict": verdict,
                     "in_force": force[name], "how": how}
        print(f"[gates] decision {name}: crossover {crossover:,} ({how}); "
              f"TPU default {TPU_DEFAULTS[name]:,}, card default "
              f"{default:,} ({verdict}); in force {force[name]:,} "
              f"[{sweep.card}]", flush=True)

    if "G1" in g:
        sizes = sorted(int(s) for s in g["G1"])
        say("device_scan_agg_min_rows", first_win(sizes, lambda s: all(
            med("G1", s, w, r, "route") < med("G1", s, w, r, "host")
            for w in g["G1"][str(s)] for r in runs)),
            "smallest lineitem size at which the warm route beats the host "
            "in every G1 statement and run")
    if "G2" in g:
        host_wins = [f"{w} at {s}" for s in g["G2"] for w in g["G2"][s]
                     if all(med("G2", s, w, r, "host")
                            < med("G2", s, w, r, "route") for r in runs)]
        dec["work_screen"] = {"host_wins": host_wins,
                              "verdict": "kept" if host_wins else "removed"}
        print(f"[gates] decision work screen: the host wins "
              f"{host_wins or 'no shape'} in both runs: "
              f"{dec['work_screen']['verdict']} [{sweep.card}]", flush=True)
    if "G3" in g:
        Gs = sorted(int(s) for s in g["G3"])
        whats = ("sum_count", "min_max")

        def fastest(G, engine):
            return all(min(g["G3"][str(G)][w][r].items(),
                           key=lambda kv: kv[1]["median"]
                           if kv[0] != "host" else float("inf"))[0] == engine
                       for w in whats for r in runs)

        def beats(G, a, b, w):
            sides = g["G3"][str(G)][w]
            return all(a in sides[r] and b in sides[r]
                       and sides[r][a]["median"] < sides[r][b]["median"]
                       for r in runs)
        mask = last_win([G for G in Gs if G <= 1 << 20],
                        lambda G: fastest(G, "mask"))
        say("device_scan_agg_max_groups", mask,
            "largest G up to which the mask engine is the fastest engine "
            "of both statements in both runs")
        say("device_scan_agg_max_groups_matmul",
            last_win(Gs, lambda G: beats(G, "matmul", "sort", "sum_count")),
            "largest G up to which the matmul engine beats the sort engine "
            "(SUM + COUNT) in both runs")
        say("device_scan_agg_max_groups_sort",
            last_win(Gs, lambda G: all(beats(G, "sort", "host", w)
                                       for w in whats)),
            "largest G up to which the sort engine beats the host in both "
            "statements and runs")
        pulls = sweep.data.get("pull_bytes", {})
        card = {n: dec[n]["card"] for n in (
            "device_scan_agg_max_groups", "device_scan_agg_max_groups_matmul")}

        def engine_at(G):
            if G <= card["device_scan_agg_max_groups"]:
                return "mask"
            if G <= card["device_scan_agg_max_groups_matmul"]:
                return "matmul"
            return "sort"
        mb = [(pulls[str(G)]["sum_count"][engine_at(G)] / 2 ** 20, G)
              for G in Gs if engine_at(G) in pulls.get(str(G), {}).get(
                  "sum_count", {})]
        mb = [(m, G) for m, G in sorted(mb) if m >= 1]
        if mb:
            best = last_win(mb, lambda mg: beats(mg[1], engine_at(mg[1]),
                                                 "host", "sum_count"))
            say("device_scan_agg_max_pull_mb", max(int(round(best[0])), 1),
                f"largest unfused [K, G] pull (MB; G = {best[1]:,}) up to "
                "which the route at the card's caps beats the host, SUM + "
                "COUNT, both runs")
    if "G5" in g:
        sizes = sorted(int(s) for s in g["G5"])
        say("vector_host_scan_max_rows", first_win(sizes, lambda s: all(
            med("G5", s, w, r, "card") < med("G5", s, w, r, "host")
            for w in g["G5"][str(s)] for r in runs)),
            "smallest corpus at which the card beats the host scan with and "
            "without a WHERE in both runs")
    if "G6" in g:
        sizes = sorted(int(s) for s in g["G6"])
        hnsw_from = first_win(sizes, lambda s: all(
            med("G6", s, "knn", r, "hnsw") < med("G6", s, "knn", r, "exact")
            for r in runs))
        say("vector_exact_scan_max_rows", hnsw_from,
            "smallest block size at which HNSW at ef = 40 beats the exact "
            "scan in both runs (the largest swept if it never does)")
    if "G7" in g:
        sizes = sorted(int(s) for s in g["G7"])
        say("DEVICE_MIN_DOCS", first_win(sizes, lambda s: all(
            med("G7", s, w, r, "served") < med("G7", s, w, r, "generic")
            for w in g["G7"][str(s)] for r in runs)),
            "smallest table at which served match() beats the generic path "
            "at B = 1 and B = 8 in both runs")
    sweep.dump()


def phase_gates_sweep(card, out=GATES_OUT):
    """``--gates``: every route gate swept on the card, the whole sweep
    GATES_RUNS times in one process, each side's first call and the median of
    GATES_REPS warm calls in turns; each gate's crossover and default by the
    half-to-twice rule; the record written to ``out`` as it grows. Rows of
    every route equal the host's."""
    from databend_tpu_torch.pipeline import device_scan_agg as dsa
    from databend_tpu_torch.storage.fuse.table import FuseTable
    from databend_tpu_torch.utils.cache import CacheManager

    print(f"[gates] in force: {gates_in_force()} [{card}]", flush=True)
    sweep = GateSweep(card, out)
    engines, pulls = [], {}
    real_program = dsa._build_program
    real_host_scores = FuseTable._host_block_scores

    def program_spy(ir):
        prog = real_program(ir)

        def run(*a):
            out = prog(*a)
            parts = out if isinstance(out, (list, tuple)) else [out]
            pulls[ir[4]] = sum(p.numel() * p.element_size() for p in parts)
            return out
        engines.append(ir[4])
        return run

    def host_scores(self, *a, **k):
        host_scores.calls += 1
        return real_host_scores(self, *a, **k)
    host_scores.calls = 0

    with tempfile.TemporaryDirectory() as root:
        loaded = gates_load(root, card)
        (tpch_ctxs, group_ctx, vec_ctx, hnsw_ctx, hnsw_truth, text_ctxs,
         pool) = loaded
        dsa._build_program = program_spy
        FuseTable._host_block_scores = host_scores
        try:
            for run in range(1, GATES_RUNS + 1):
                t0 = time.perf_counter()
                sweep_text(sweep, run, text_ctxs, pool)
                sweep_vectors(sweep, run, vec_ctx, hnsw_ctx, hnsw_truth)
                sweep_agg(sweep, run, tpch_ctxs, group_ctx, engines, pulls)
                print(f"[gates] run {run}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
        finally:
            dsa._build_program = real_program
            FuseTable._host_block_scores = real_host_scores
            for c in ([c for _, c in tpch_ctxs.values()] + [group_ctx]
                      + [vec_ctx[0], hnsw_ctx[0]] + list(text_ctxs.values())):
                c.close()
            CacheManager.instance().clear_all()
            dsa._cache().clear()
    gates_decide(sweep)
    check(not sweep.faults, "gate sweep faults: " + "; ".join(sweep.faults))


def phase_gates(card):
    """The default run's gate check: the gates in force, and one statement on
    each side of G1 (TPC-H Q6 over lineitem of one row under and of exactly
    ``device_scan_agg_min_rows`` rows: only the second routes) and of G7
    (prepared match() over a table of one doc under and of exactly
    ``_MatchServer.DEVICE_MIN_DOCS`` docs: only the second is served), each
    with the host's (the generic path's) rows."""
    import databend_tpu_torch as dt
    from benchmarks.tpch import QUERIES, generate
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.ops.impact_bm25 import impact_bm25_topk
    from databend_tpu_torch.service.prepared import _MatchServer
    from databend_tpu_torch.types import String

    force = gates_in_force()
    print(f"[gates] in force: {force} [{card}]", flush=True)
    gate = force["device_scan_agg_min_rows"]
    docs = _MatchServer.DEVICE_MIN_DOCS
    li = generate(gate / 6_000_000 * 1.01 + 1e-3, seed=AGG_SEED)["lineitem"]
    rng = np.random.default_rng(MATCH_SEED)
    words = np.array(MATCH_WORDS)[rng.integers(0, len(MATCH_WORDS),
                                               (docs, 4))]
    n_words = rng.integers(2, 5, docs)
    texts = [" ".join(words[i, :n_words[i]]) for i in range(docs)]
    with tempfile.TemporaryDirectory() as root:
        for side, rows in (("under", gate - 1), ("at", gate)):
            ctx = dt.SessionContext(os.path.join(root, side))
            try:
                load_lineitem(ctx, {c: v[:rows] for c, v in li.items()})
                ctx.sql("SET enable_device_local_execution = 0")
                host = ctx.sql(QUERIES["q6"]).rows()
                ctx.sql("SET enable_device_local_execution = 1")
                before = gate_route_counts()
                got = ctx.sql(QUERIES["q6"]).rows()
                routed = gate_route_counts()[0] - before[0]
            finally:
                ctx.close()
            check(same_rows(host, got), f"[gates] G1 {side}: rows differ "
                                        "from the host's")
            check(routed == (side == "at"),
                  f"[gates] G1: {rows} rows, routed {routed}")
            print(f"[gates] G1 {rows:,} lineitem rows ({side} the gate): "
                  f"Q6 routed {bool(routed)}, rows equal the host's "
                  f"[{card}]", flush=True)
        for side, n in (("under", docs - 1), ("at", docs)):
            ctx = dt.SessionContext(os.path.join(root, f"text_{side}"))
            try:
                ctx.sql("CREATE TABLE d (id BIGINT, body VARCHAR)")
                ctx.sql("CREATE INVERTED INDEX di ON d(body)")
                ctx.insert_block("d", DataBlock(
                    ["id", "body"],
                    [Column.from_numpy(np.arange(n, dtype=np.int64)),
                     Column.from_pylist(texts[:n], String)]))
                sql = ("SELECT id, score() FROM d WHERE match(body, {}) "
                       "ORDER BY score() DESC LIMIT 10")
                pm = ctx.prepare(sql.format("?"))
                before = impact_bm25_topk.launches
                got = pm.execute("cat news").rows()
                served = impact_bm25_topk.launches > before \
                    and pm._match._snap_id is not None
                want = ctx.sql(sql.format("'cat news'")).rows()
            finally:
                ctx.close()
            check(same_match(want, got), f"[gates] G7 {side}: rows differ "
                                         "from the generic path's")
            check(served == (side == "at"),
                  f"[gates] G7: {n} docs, served {served}")
            print(f"[gates] G7 {n:,} docs ({side} the gate): prepared "
                  f"match() served {served}, rows equal the generic path's "
                  f"[{card}]", flush=True)



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import databend_tpu_torch  # noqa: F401  (fails outside the repo)

    args = sys.argv[1:]
    if args[:1] == ["--multihost-worker"]:
        return multihost_worker(args[1], args[2], int(args[3]), int(args[4]))
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if "--multihost" in args:
        multihost_alone(card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--gates" in args:
        at = args.index("--gates") + 1
        build_kernels()
        phase_gates_sweep(card, args[at] if at < len(args) else GATES_OUT)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    build_kernels()
    kern = phase_kernels(card)
    rerank = phase_rerank_kernel(card)
    imp, topk = phase_impact_kernels(card)
    gsk = phase_grouped_sums_kernel(card)
    exk = phase_exact_kernel(card)
    if "--diagnose" in sys.argv[1:]:
        diagnose_flash(card)
        diagnose_grouped_sums(card)
        diagnose_exact(card)
    profile = "--profile" in sys.argv[1:]
    exact_launches = phase_ties(card)
    launches, main_exact, x, queries, gt = phase_main_path(card, profile)
    check(launches > 0, "the main path launched flash_group_minima no time")
    check(main_exact > 0, "the main path launched exact_topk_select no time")
    exact_launches += main_exact
    phase_sq8(card, x, queries, gt)
    del x, queries, gt
    topk_launches, imp_launches = phase_match(card, profile)
    check(topk_launches > 0, "the [match] path launched impact_bm25_topk "
                             "no time")
    check(imp_launches > 0, "the [match] path above the largest k launched "
                            "impact_bm25_scores no time")
    exact_launches += phase_hnsw(card, profile)
    phase_cluster(card)
    phase_gates(card)
    with tempfile.TemporaryDirectory() as work:
        gs_launches, captured, tpch_launches, dist_rows = phase_agg(
            card, profile, os.path.join(work, "tpch"))
        check(gs_launches > 0, "the [agg] path launched grouped_sums no time")
        gs_launches += tpch_launches
        gsk.update(hold_grouped_sums_agg(card, captured))
        del captured
        mesh_ref = phase_mesh(card, work)
        exact_launches += mesh_ref["exact_launches"]
        phase_multihost(card, work, mesh_ref, dist_rows)
    phase_suites(card)
    check_standalone()

    err = max(v[0] for v in kern.values())
    # the serving chunk shape
    _, ms, plain_ms, bound_ms, bound_by = kern[("l2", 256, DIM)]
    kernels = [{
        "name": "flash_group_minima", "route": "cuda",
        "source": "databend_tpu_torch/csrc/flash_group_minima.cu",
        "replaces": "databend_tpu/ops/flash_topk.py:94",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]
    # the serving shape of a B = 128 text batch on one block
    _, ms, plain_ms, bound_ms, bound_by = imp[("OR", 8, 128, 4)]
    kernels.append({
        "name": "impact_bm25_scores", "route": "cuda",
        "source": "databend_tpu_torch/csrc/impact_bm25_scores.cu",
        "replaces": "databend_tpu/index/inverted/device.py:409",
        "launches": imp_launches,
        "max_abs_err": max(v[0] for v in imp.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None})
    # the same serving shape, k = 10; no single PyTorch call selects the
    # tie-rule top-k of BM25 scores: the yardstick is the pair it replaces
    _, ms, plain_ms, bound_ms, bound_by, pair_ms = topk[("OR", 8, 128, 4)]
    kernels.append({
        "name": "impact_bm25_topk", "route": "cuda",
        "source": "databend_tpu_torch/csrc/impact_bm25_scores.cu",
        "replaces": "databend_tpu/index/inverted/device.py:424",
        "launches": topk_launches,
        "max_abs_err": max(v[0] for v in topk.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": pair_ms})
    # the kernel on Q1's own inputs (mask engine, G = 12)
    _, ms, plain_ms, bound_ms, bound_by, library_ms, _ = gsk["q1"]
    kernels.append({
        "name": "grouped_sums", "route": "cuda",
        "source": "databend_tpu_torch/csrc/grouped_sums.cu",
        "replaces": "databend_tpu/pipeline/device_scan_agg.py:1033",
        "launches": gs_launches,
        "max_abs_err": max(v[0] for v in gsk.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms})
    # the serving chunk: B = 256 against 1M whole-number rows, l2, k = 10;
    # no single PyTorch call computes the re-rank: the plain version is the
    # library composition it replaces
    _, ms, plain_ms, bound_ms, bound_by = rerank[("l2", 256, DIM)]
    kernels.append({
        "name": "flash_rerank", "route": "cuda",
        "source": "databend_tpu_torch/csrc/flash_rerank.cu",
        "replaces": None,
        "launches": launches, "max_abs_err": max(v[0] for v in rerank.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})
    # the serving chunk: b = 256 against 1M rows, l2, k = 10; the library
    # yardstick is torch.topk over the finished distances (no tie rule)
    _, ms, plain_ms, bound_ms, bound_by, topk_ms = exk[("l2", 256, K)]
    kernels.append({
        "name": "exact_topk_select", "route": "cuda",
        "source": "databend_tpu_torch/csrc/exact_topk_select.cu",
        "replaces": "databend_tpu/storage/fuse/table.py:1084",
        "launches": exact_launches,
        "max_abs_err": max(v[0] for v in exk.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": topk_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
