"""Time both entry points of ``csrc/impact_bm25_scores.cu`` of several
checkouts in turns on one CUDA card.

    python3 scripts/impact_scores_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``databend_tpu_torch/`` (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and the working tree). For each ROOT, in the order given, one process
imports that checkout's ``databend_tpu_torch.ops.impact_bm25``, builds its
kernels and runs the nine shapes of ``chip_smoke.py``'s kernel phase (a block
of 262,144 docs: L = 8, b = 128, m = 4 OR, AND, fused cosine and fused l2;
L = 8, b = 8; L = 64, b = 128, m = 8; L = 512, b = 8 AND; b = 1; a block
ending in 1,000 pad docs), the same seeded inputs in every process (packed by
that checkout's ``pack_query_terms``). At each shape ``impact_bm25_scores``
must be bit-equal to that checkout's plain version and ``impact_bm25_topk``
at k = 10 must give the plain version's ids and value bits; then each is
timed with CUDA events, the mean of 20 calls after one warm-up: on the card
(the calls captured in one CUDA graph and replayed) and a call of the
wrapper from the host, and printed on an ``[ab]`` line beside its bound,
that of ``chip_smoke.impact_bound``: one read of the layout, the query
operands and the distance term and one write of the output at 3.35 TB/s
(``sat`` only at the slots some query term asks for), or
one f32 product at 67 TFLOP/s and one f64 sum at half that rate per
(query, doc, real query term) and, for the selection, one key compare per
(query, doc) at the int32 rate, whichever is larger: the function's work,
whatever design runs it.
The pair the selecting kernel replaced (``impact_bm25_scores``, then
``topk_largest_lowest_index``) is timed the same ways at k = 10.
Give the roots as A, B, B, A to compare two trees on one card. Exits
non-zero if a run fails.
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
from databend_tpu_torch.ops import impact_bm25 as ib

card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
N, D, K, REPS = 262_144, 128, 10, 20


def operands(g, n_docs, slots, b, m, and_mode, metric):
    """chip_smoke.impact_operands: docs of L/4 to L/2 distinct terms of a
    prime vocabulary, queries of m/2 terms in groups of one."""
    vocab = {8: 17, 64: 131, 512: 1031}[slots]

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    ar = torch.arange(slots, device="cuda", dtype=torch.int32)[None, :]
    term_ids = (rint(0, vocab, (N, 1)) + ar * rint(1, vocab, (N, 1))) % vocab
    real = ar < rint(slots // 4, slots // 2 + 1, (N, 1))
    real &= torch.arange(N, device="cuda")[:, None] < n_docs
    term_ids = torch.where(real, term_ids, -2).contiguous()
    sat = torch.where(real, 0.5 + 1.5 * torch.rand(
        (N, slots), generator=g, device="cuda"), 0.0)
    live = torch.arange(m, device="cuda")[None, :].expand(b, m) < m // 2
    qterms = torch.where(live, rint(0, vocab, (b, m)), -1)
    idf = torch.where(live, 0.5 + 2.5 * torch.rand(
        (b, m), generator=g, device="cuda"), 0.0)
    qgroup = torch.where(live, torch.arange(
        m, device="cuda", dtype=torch.int32)[None, :].expand(b, m), -1)
    need = torch.full((b,), float(m // 2 if and_mode else 1), device="cuda")
    dist, w_s, w_d = None, 1.0, 0.0
    if metric:
        emb = torch.nn.functional.normalize(torch.randn(
            N, D, generator=g, device="cuda"), dim=1)
        q = torch.nn.functional.normalize(torch.randn(
            b, D, generator=g, device="cuda"), dim=1)
        dist = 1.0 - q @ emb.T
        w_s, w_d = 0.04, -1.0
        if metric == "l2":
            dist = torch.sqrt(2.0 * dist.clamp_min(0.0))
            w_s, w_d = -0.04, 1.0
    ops = (term_ids, sat, ib.pack_query_terms(qterms, idf, qgroup), need)
    return ops, dist, w_s, w_d


def bits(t):
    return t.contiguous().view(torch.int32)


def ms_of(fn, graph):
    """ms a call: REPS calls after a warm-up, launched from the host
    (``graph`` False: the wrapper's time included) or captured in one CUDA
    graph and replayed (the device time alone)."""
    fn()
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(REPS):
                fn()
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for _ in range(REPS):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


g = torch.Generator(device="cuda").manual_seed(9)
shapes = [("OR", N, 8, 128, 4, False, None),
          ("AND", N, 8, 128, 4, True, None),
          ("fused cosine", N, 8, 128, 4, False, "cosine"),
          ("fused l2", N, 8, 128, 4, False, "l2"),
          ("OR", N, 8, 8, 4, False, None),
          ("OR", N, 64, 128, 8, False, None),
          ("AND", N, 512, 8, 4, True, None),
          ("OR", N, 8, 1, 4, False, None),
          ("OR ragged", N - 1000, 8, 128, 4, False, None)]
for name, n_docs, slots, b, m, and_mode, metric in shapes:
    ops, dist, w_s, w_d = operands(g, n_docs, slots, b, m, and_mode, metric)
    what = f"{name} L={slots} b={b} m={m}"
    got = ib.impact_bm25_scores(*ops, dist, w_s, w_d)
    want = ib._impact_bm25_scores_plain(*ops, dist, w_s, w_d)
    if not torch.equal(bits(got), bits(want)):
        sys.exit(f"{root}: scores {what} differ from the plain version")
    vals, ids = ib.impact_bm25_topk(*ops, K, dist, w_s, w_d)
    wv, wi = ib.topk_largest_lowest_index(want, K)
    if not (torch.equal(ids, wi) and torch.equal(bits(vals), bits(wv))):
        sys.exit(f"{root}: topk {what} differs from the plain version")
    del got, want, vals, ids, wv, wi
    read = sum(t.numel() * t.element_size() for t in ops) \
        + (dist.numel() * 4 if dist is not None else 0)
    terms = ops[2][..., 0]
    # the function needs sat only where some query asks for the slot's term
    read -= ops[1].numel() * 4 - 4 * int(
        torch.isin(ops[0], terms[terms >= 0]).sum())
    # one f32 product and one f64 sum, at half the f32 rate, a term
    products = int((terms >= 0).sum()) * N * (1 / 67e12 + 2 / 67e12) * 1e3
    for entry, moved, t_ops, fn in (
            ("impact_bm25_scores", read + b * N * 4, products,
             lambda: ib.impact_bm25_scores(*ops, dist, w_s, w_d)),
            ("impact_bm25_topk k=10", read + b * K * 12,
             products + b * N / (132 * 64 * 1.98e9) * 1e3,
             lambda: ib.impact_bm25_topk(*ops, K, dist, w_s, w_d))):
        ms, call_ms = ms_of(fn, True), ms_of(fn, False)
        bound, by = max((moved / 3.35e12 * 1e3, "bytes"),
                        (t_ops, "operations"))
        print(f"[ab] {root}: {entry} {what}: {ms:.4f} ms on the card "
              f"({call_ms:.4f} ms a call of the wrapper), bound "
              f"{bound:.4f} ms ({by}, {100 * bound / ms:.0f}%) [{card}]",
              flush=True)
    # the pair the selecting kernel replaced: the scores, then the top-k
    pair = lambda: ib.topk_largest_lowest_index(      # noqa: E731
        ib.impact_bm25_scores(*ops, dist, w_s, w_d), K)
    print(f"[ab] {root}: the pair k=10 {what}: {ms_of(pair, True):.4f} ms "
          f"on the card "
          f"({ms_of(pair, False):.4f} ms a call of the wrappers) [{card}]",
          flush=True)
    del ops, dist
    torch.cuda.empty_cache()
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
