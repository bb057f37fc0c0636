"""Time the exact-KNN selection kernel and the paths that run it, for
several checkouts in turns on one CUDA card.

    python3 scripts/exact_ties_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``databend_tpu_torch/`` and ``chip_smoke.py``
(for example a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, and the working tree). For each ROOT, in the
order given, one process imports that checkout's package and prints
``[ab]`` lines:

* ``ops.exact_topk.exact_topk_select`` alone, on the card (a CUDA graph
  replay of 20 calls, the checkout's ``chip_smoke.device_ms``), on product
  blocks made on the card from seed 7 (the same in every process): the
  serving chunk (256 SIFT-valued queries against 1,000,000 rows of 128) at
  k = 10 under l2, cosine and ip, at k = 128 under l2, and with a mask a
  query (5% kept); the HNSW build's batch (1,024 unit rows against 65,536,
  ip, bf16 product, k = 101); ``[mesh]``'s chunk (8 standard normal
  queries against 131,072 rows of 96, l2, k = 10); each beside its ids'
  agreement with the plain version;
* ``execute_batch`` of the prepared l2 statement at B = 256, exact, on the
  main path's corpus (``chip_smoke.sift_like``: 1,000,000 x 128 integers in
  [0, 255], 1,000 centres, seed 7): the whole call (host clock, the median
  of 5 after a warm-up);
* the checkout's ``chip_smoke.profile_modes``: whole call, ``_topk`` and
  device busy per batch of ``execute_batch_block`` at B = 1,024, l2 exact,
  l2 approximate (the control: it runs no exact selection) and cosine
  approximate (torch.profiler over 3 batches);
* ``[mesh]``: one shard's ``ops.topk.chunked_topk_smallest`` (B = 8 against
  2,500,000 x 96 rows made on the card from seed 5, chunks of 131,072,
  f32): whole call (median of 5) and device busy; then the warm f32 batch of
  configuration 5 (``parallel.sharded_brute_force_topk`` over 10,000,000 x
  96 rows in 4 logical shards of the card, B = 8, k = 10): whole call
  (median of 5) and device busy and its idle share (torch.profiler over 3
  batches);
* the HNSW build's kNN stage, ``index.hnsw.build._knn_graph_np`` over
  262,144 unit rows of 128 (one ``[hnsw]`` block's shape, from seed 23;
  k = 100 + 1, bf16 products): seconds, one call after a warm-up over the
  first 4,096 rows.

Give the roots as A, B, B, A to compare two trees on one card. Exits
non-zero if a run fails.
"""

import os
import subprocess
import sys

CHILD = r'''
import os, sys, tempfile, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import numpy as np
import torch
import chip_smoke as cs
import databend_tpu_torch as dt
from databend_tpu_torch.expression import Column, DataBlock
from databend_tpu_torch.ops import distance, topk
from databend_tpu_torch.types import VectorType

card = cs.card_line()
rng = np.random.default_rng(cs.SEED)
centers = rng.integers(0, 256, size=(1000, cs.DIM)).astype(np.float32)
x = cs.sift_like(rng, cs.N_ROWS, centers)
queries = cs.sift_like(rng, 1024, centers)

from databend_tpu_torch.ops import exact_topk


def kernel(what, qx, qq, xx, metric, k, keep=None):
    ms = cs.device_ms(lambda: exact_topk.exact_topk_select(
        qx, qq, xx, metric, k, None, keep))
    same = torch.equal(
        exact_topk.exact_topk_select(qx, qq, xx, metric, k, None, keep)[1],
        exact_topk._exact_topk_select_plain(qx, qq, xx, metric, k, None,
                                            keep)[1])
    print(f"[ab] {root}: exact_topk_select {what}: {ms:.4f} ms on the card "
          f"(CUDA graph); ids equal to the plain version: {same} [{card}]",
          flush=True)


g = torch.Generator(device="cuda").manual_seed(cs.SEED)
xk = torch.randint(0, 256, (cs.N_ROWS, cs.DIM), generator=g, device="cuda",
                   dtype=torch.int32).float()
qk = xk[torch.randint(0, cs.N_ROWS, (256,), generator=g, device="cuda")] \
    + torch.randn(256, cs.DIM, generator=g, device="cuda")
for metric in ("l2", "cosine", "ip"):
    xm = distance.normalize(xk) if metric == "cosine" else xk
    ops = distance.pairwise_product(qk, xm, metric,
                                    x_normalized=metric == "cosine")
    kernel(f"{metric} b=256 N={cs.N_ROWS} k={cs.K}", *ops, metric, cs.K)
    if metric == "l2":
        kernel(f"l2 b=256 N={cs.N_ROWS} k=128", *ops, metric, 128)
        keep = torch.rand(256, cs.N_ROWS, generator=g, device="cuda") < 0.05
        kernel("l2 b=256, a mask a query (5% kept)", *ops, metric, cs.K,
               keep)
        del keep
    del ops, xm
del xk, qk
torch.cuda.empty_cache()
xh = distance.normalize(torch.randn(65_536, cs.DIM, generator=g,
                                    device="cuda"))
kernel("ip b=1024 N=65536 k=101, bf16 product",
       *distance.pairwise_product(xh[:1024], xh, "ip", torch.bfloat16),
       "ip", 101)
del xh
xm = torch.randn(131_072, cs.MESH_DIM, generator=g, device="cuda")
qm = torch.randn(cs.MESH_B, cs.MESH_DIM, generator=g, device="cuda")
kernel(f"l2 b={cs.MESH_B} N=131072 D={cs.MESH_DIM} k={cs.K}",
       *distance.pairwise_product(qm, xm, "l2"), "l2", cs.K)
del xm, qm
torch.cuda.empty_cache()

with tempfile.TemporaryDirectory() as tmp:
    ctx = dt.SessionContext(tmp)
    ctx.sql(f"CREATE TABLE t (id BIGINT, emb VECTOR({cs.DIM})) "
            "ROW_PER_BLOCK='262144'")
    ctx.sql("CREATE VECTOR INDEX tv ON t(emb) distance='l2,cosine'")
    ctx.insert_block("t", DataBlock(
        ["id", "emb"], [Column.from_numpy(np.arange(cs.N_ROWS, dtype=np.int64)),
                        Column.from_numpy(x, VectorType(cs.DIM))]))
    ps = ctx.prepare("SELECT id, l2_distance(emb, ?) AS d FROM t "
                     "ORDER BY l2_distance(emb, ?) LIMIT 10")
    sets = [(v, v) for v in queries[:256]]
    ps.execute_batch(sets, exact=True)
    whole = []
    for _ in range(5):
        t0 = time.perf_counter()
        ps.execute_batch(sets, exact=True)
        torch.cuda.synchronize()
        whole.append(time.perf_counter() - t0)
    print(f"[ab] {root}: execute_batch l2 exact B=256: whole call "
          f"{float(np.median(whole)) * 1e3:.3f} ms (median of 5; "
          f"{min(whole) * 1e3:.3f}-{max(whole) * 1e3:.3f}) [{card}]",
          flush=True)
    cs.profile_modes(ctx, queries, card)
    ctx.close()
del x

g = torch.Generator(device="cuda").manual_seed(cs.MESH_SEED)
xs = torch.randn(cs.MESH_ROWS // cs.MESH_SHARDS, cs.MESH_DIM, generator=g,
                 device="cuda")
qs = torch.randn(cs.MESH_B, cs.MESH_DIM, generator=g, device="cuda")
scan = lambda r=0: topk.chunked_topk_smallest(qs, xs, cs.K, "l2")
scan()
torch.cuda.synchronize()
whole = []
for _ in range(5):
    t0 = time.perf_counter()
    scan()
    torch.cuda.synchronize()
    whole.append(time.perf_counter() - t0)
_, busy = cs.device_busy(scan)
print(f"[ab] {root}: one [mesh] shard, chunked_topk_smallest B={cs.MESH_B} "
      f"over {xs.shape[0]} x {cs.MESH_DIM}, f32: whole call "
      f"{float(np.median(whole)) * 1e3:.3f} ms (median of 5; "
      f"{min(whole) * 1e3:.3f}-{max(whole) * 1e3:.3f}), device busy "
      f"{busy:.3f} ms [{card}]", flush=True)
del xs, qs
torch.cuda.empty_cache()

from databend_tpu_torch import parallel
from databend_tpu_torch.parallel import mesh as pm
g = torch.Generator(device="cuda").manual_seed(cs.MESH_SEED)
xm = torch.randn(cs.MESH_ROWS, cs.MESH_DIM, generator=g, device="cuda").cpu()
qm = torch.randn(cs.MESH_B, cs.MESH_DIM, generator=g, device="cuda").cpu()
m = pm.make_mesh(cs.MESH_SHARDS, devices=[torch.device("cuda:0")] * 4)
x_dev, n_valid = parallel.shard_rows(xm.numpy(), m)
q_dev = pm.device_put(qm.numpy(), parallel.query_sharding(m))
del xm
batch = lambda: parallel.sharded_brute_force_topk(
    m, q_dev, x_dev, cs.K, "l2", bf16=False, n_valid=n_valid)
batch()
torch.cuda.synchronize()
whole = []
for _ in range(5):
    t0 = time.perf_counter()
    np.asarray(batch()[1])
    whole.append(time.perf_counter() - t0)
w, busy = cs.device_busy(batch)
print(f"[ab] {root}: [mesh] warm f32 batch B={cs.MESH_B} over "
      f"{cs.MESH_ROWS} x {cs.MESH_DIM} in {cs.MESH_SHARDS} logical shards: "
      f"whole call {float(np.median(whole)) * 1e3:.3f} ms (median of 5; "
      f"{min(whole) * 1e3:.3f}-{max(whole) * 1e3:.3f}), device busy "
      f"{busy:.3f} ms of {w:.3f}, idle {100 * (1 - busy / w):.0f}% [{card}]",
      flush=True)
del x_dev, q_dev
torch.cuda.empty_cache()

from databend_tpu_torch.index.hnsw import build as hb
g = torch.Generator(device="cuda").manual_seed(cs.HNSW_SEED)
xh = distance.normalize(torch.randn(cs.BLOCK_ROWS, cs.DIM, generator=g,
                                    device="cuda"))
hb._knn_graph_np(xh[:4096], 4096, 100, "ip")
t0 = time.perf_counter()
hb._knn_graph_np(xh, cs.BLOCK_ROWS, 100, "ip")
print(f"[ab] {root}: HNSW build kNN stage, _knn_graph_np over "
      f"{cs.BLOCK_ROWS} x {cs.DIM} unit rows, k = 100 + 1, bf16: "
      f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
'''


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        print(f"[ab] ==== {os.path.abspath(root)}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD, root])
        if proc.returncode:
            print(f"[ab] {root}: exit {proc.returncode}", flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
