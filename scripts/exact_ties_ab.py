"""Time the exact-KNN selection and the vector serving modes of several
checkouts in turns on one CUDA card.

    python3 scripts/exact_ties_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``databend_tpu_torch/`` and ``chip_smoke.py``
(for example a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, and the working tree). For each ROOT, in the
order given, one process imports that checkout's package, makes the main
path's corpus with its ``chip_smoke.sift_like`` (1,000,000 x 128 integers in
[0, 255], 1,000 centres, seed 7; the same rows in every process) and prints
``[ab]`` lines:

* the selection alone on one [256, 1,000,000] l2 score block of the first
  256 queries: ``ops.topk.topk_smallest_lowest_index`` where the checkout
  has it (equal distances by ascending row id), else the bare
  ``torch.topk`` it replaces (CUDA events, the mean of 10 calls after a
  warm-up), beside the share of the 256 rows that tie across rank 10;
* ``execute_batch`` of the prepared l2 statement at B = 256, exact: the
  whole call (host clock, the median of 5 after a warm-up);
* the checkout's ``chip_smoke.profile_modes``: whole call, ``_topk`` and
  device busy per batch of ``execute_batch_block`` at B = 1,024, l2 exact,
  l2 approximate and cosine approximate (torch.profiler over 3 batches).

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

select = getattr(topk, "topk_smallest_lowest_index", None)
name = "topk_smallest_lowest_index"
if select is None:
    name = "torch.topk"
    select = lambda d, k: torch.topk(d, k, dim=1, largest=False)
d = distance.pairwise_distance(torch.from_numpy(queries[:256]).cuda(),
                               torch.from_numpy(x).cuda(), "l2")
kth = torch.topk(d, cs.K, dim=1, largest=False).values[:, -1:]
tied = ((d <= kth).sum(1) > cs.K).float().mean().item()
ms = cs.cuda_ms(lambda: select(d, cs.K), reps=10)
print(f"[ab] {root}: selection ({name}) over [256, {cs.N_ROWS}] l2 scores, "
      f"k = {cs.K}: {ms:.4f} ms; {100 * tied:.1f}% of rows tie across rank "
      f"{cs.K} [{card}]", flush=True)
del d, kth
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
