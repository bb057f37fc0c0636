"""Time ``grouped_sums`` of several checkouts in turns on one CUDA card.

    python3 scripts/grouped_sums_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``databend_tpu_torch/`` (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and the working tree). For each ROOT, in the order given, one process
imports that checkout's ``databend_tpu_torch.ops.grouped_sums``, builds its
kernel and times ``grouped_sums`` at the sweep shapes of ``chip_smoke.py``
(n of 6M and 8M, K of 6 and 20, G of 1, 12, 64, 10,001, 65,536 and
200,000; the same seeded inputs in every process, the value rows as one
[K, n] block, the form every tree takes), each call bit-equal to that
checkout's plain version first. It prints one ``[ab]`` line a shape with
the kernel's ms (CUDA events, the mean of 20 calls after one warm-up)
beside the bound (one read of gid and the rows, one write of the sums at
3.35 TB/s). Give the roots as A, B, B, A to compare two trees on one card.
Exits non-zero if a run fails.
"""

import os
import subprocess
import sys

CHILD = r'''
import os, subprocess, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
from databend_tpu_torch.ops import grouped_sums as gs

card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
g = torch.Generator(device="cuda").manual_seed(10)
for n in (6_000_000, 8_000_000):
    for k in (6, 20):
        rows = torch.randint(-255, 256, (k, n), generator=g, device="cuda",
                             dtype=torch.int32)
        for groups in (1, 12, 64, 10_001, 65_536, 200_000):
            gid = torch.randint(0, groups + 1, (n,), generator=g,
                                device="cuda", dtype=torch.int32)
            got = gs.grouped_sums(gid, rows, groups)
            if not torch.equal(got, gs._grouped_sums_plain(gid, rows, groups)):
                sys.exit(f"{root}: n={n} K={k} G={groups} differs from plain")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                gs.grouped_sums(gid, rows, groups)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            bound = 4 * (n + k * n + k * (groups + 1)) / 3.35e12 * 1e3
            print(f"[ab] {root}: n={n} K={k} G={groups}: {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.0f}%) [{card}]",
                  flush=True)
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
