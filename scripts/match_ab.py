"""Profile the text serving phase of ``chip_smoke.py`` in several checkouts,
in turns, on one CUDA card.

    python3 scripts/match_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``chip_smoke.py`` and ``databend_tpu_torch/``
(for example a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, and the working tree). For each ROOT, in the order
given, one process imports that checkout's ``chip_smoke``, builds its
kernels and runs its ``phase_match`` with profiling on: the served
``match()`` and fused batches, checked against the generic statement and a
numpy BM25, and ``torch.profiler`` over three B = 128 text and fused calls
(whole call, device busy, idle share, device items). Around every served
batch ``_MatchServer.run_batch`` is wrapped to read the peak device memory
the call allocates above what was resident before it; the largest per mode
and batch size is printed as ``[ab]`` lines. Give the roots as A, B, B, A to
compare two trees on one card. Exits non-zero if a run fails.
"""

import os
import subprocess
import sys

CHILD = r'''
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from databend_tpu_torch.service import prepared

real = prepared._MatchServer.run_batch
peaks = {}


def run_batch(self, texts, Q=None):
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = real(self, texts, Q)
    torch.cuda.synchronize()
    key = ("fused" if Q is not None else "text", len(texts))
    peaks[key] = max(peaks.get(key, 0),
                     torch.cuda.max_memory_allocated() - resident)
    return out


prepared._MatchServer.run_batch = run_batch
card = cs.card_line()
cs.build_kernels()
cs.phase_match(card, True)
for (mode, b), peak in sorted(peaks.items()):
    print(f"[ab] {root}: {mode} B={b}: peak device memory {peak} bytes "
          f"({peak / 2**20:.3f} MiB) above the resident [{card}]")
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
