"""Drive the port's exact-KNN serving path once on one CUDA card.

    python3 chip_smoke.py [--profile] [--diagnose]

Phases (any failure exits non-zero and prints no result line):
  1. the card: name, power limit, torch and CUDA versions;
  2. build the hand-written kernels from databend_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version (atol FLASH_TOL * max
     |score|, the same +inf pattern on pad rows), timed with CUDA events
     beside its bound (one read of its inputs and one write of its output at
     3.35 TB/s, or its bf16 FLOPs at 989 TFLOP/s, whichever is larger): at
     the serving shapes (1M x 128 corpus padded to the flash tile, l2 and
     ip, B = 256 as the server launches it, B = 1024, and B = 300 with a
     partial last query block), at wide embeddings (D in {400, 768, 1536}),
     and on a 262,144-row corpus with tile = 4096, tile = 128 (one step per
     tile) and D = 48; ptxas must report no spill;
  4. the main path: SessionContext, CREATE TABLE / VECTOR INDEX, insert of
     1,000,000 SIFT1M-shaped rows (128-d integer values in [0, 255], seed 7),
     a literal KNN query, execute_batch (B=256), execute_batch_block
     (B=1024, exact and approximate; B=256 approximate runs the exact
     program and launches no kernel) and a cosine batch; recall@10 against
     a numpy ground truth on 16 queries, launch counts of every kernel;
  5. with --profile, after the launch counts are read: torch.profiler over
     3 batches of each execute_batch_block mode (whole call, _topk, device
     busy, the biggest device items);
     with --diagnose, after the kernel phase: two timing-only variants of
     the kernel source (one without the wgmma, one without the fold into
     the minima; their results are wrong and the port never loads them)
     beside the kernel, to show which part holds it;
  6. [cluster]: CREATE TABLE ... CLUSTER BY (emb) and an insert of 262,144
     SIFT-shaped rows (the reference's batch of 64 clusters): k-means runs
     on the card, its cluster runs cover every row once, and a KNN query on
     the clustered table reaches recall@10 >= 0.99;
  7. [suites]: ``python -m databend_tpu_torch sqllogic tests/suites/index``
     on the card exits 0;
  8. stand-alone: every loaded port module comes from the port's own
     directory, and no jax or databend_tpu module was loaded.
The last line is {"ok": true, "device": {...}}.
"""

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
CLUSTER_ROWS = 262_144  # the reference's k-means batch (index/kmeans.py)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor-core peak, same source


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


def hold_flash_kernel(card, metric, q, xb, nb, tile=16384):
    """One launch of flash_group_minima against its plain version on the
    same tensors (FLASH_TOL, same +inf pattern; the corpus ends in pad rows
    with +inf norms), then both timed beside the bound. Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
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


def phase_kernels(card):
    from databend_tpu_torch.ops import _cuda
    from databend_tpu_torch.ops.flash_topk import pad_for_flash
    t0 = time.perf_counter()
    built = _cuda.build("flash_group_minima")
    print(f"[build] flash_group_minima.cu: nvcc {built['seconds']:.2f} s "
          f"(phase {time.perf_counter() - t0:.2f} s)")
    print(built["log"].strip())
    spills = [ln for ln in built["log"].splitlines() if "spill" in ln]
    check(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                         for ln in spills), f"ptxas reports spills: {spills}")
    check("C7518" not in built["log"], "ptxas serialised the wgmma")
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
        results[(metric, b, d, tile)] = hold_flash_kernel(card, metric, q, xb,
                                                          nb, tile)
        del x, norms, xb, nb, q
    torch.cuda.empty_cache()
    return results


# --diagnose: text patches of csrc/flash_group_minima.cu, each (old, new)
# occurring once. Timing only: the variants compute wrong minima.
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
}


def diagnose_flash(card):
    """Time the kernel beside its two timing-only variants at D = 128 on the
    1M-row corpus, in turns on this card: B = 128 (one query block a tile:
    every tile comes from device memory), 256 and 1024."""
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


def phase_main_path(card, profile):
    import databend_tpu_torch as dt
    from databend_tpu_torch.expression import Column, DataBlock
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
            run_queries(ctx, queries, gt, card, ft)
            launches = ft.flash_group_minima.launches
            if profile:
                profile_modes(ctx, queries, card)
            return launches
        finally:
            ctx.close()


def _ids_scores(res, b):
    ids = np.asarray(res.block.column("id").numpy(), np.int64).reshape(b, K)
    d = np.asarray(res.block.column("d").numpy(), np.float32).reshape(b, K)
    return ids, d


def run_queries(ctx, queries, gt, card, ft):
    d_l2, kth_l2 = gt["l2"]
    d_cos, kth_cos = gt["cosine"]

    lit = "[" + ",".join(str(int(v)) for v in queries[0]) + "]"
    t0 = time.perf_counter()
    rows = ctx.sql(f"SELECT id FROM t ORDER BY l2_distance(emb, {lit}) "
                   "LIMIT 10").rows()
    lit_s = time.perf_counter() - t0
    r = recall(np.array([[i for (i,) in rows]]), d_l2[:1], kth_l2[:1])
    print(f"[main] literal ctx.sql KNN: {lit_s:.3f} s (first query, loads the "
          f"corpus), recall@10 {r} [{card}]")
    check(len(rows) == K and r >= 0.99, f"literal KNN recall {r}")

    ps = ctx.prepare("SELECT id FROM t ORDER BY l2_distance(emb, ?) LIMIT 10")
    q256 = queries[:256]
    ps.execute_batch(q256)                                     # warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = ps.execute_batch(q256)
        times.append(time.perf_counter() - t0)
    dt_b = float(np.median(times))
    ids = np.array([[i for (i,) in rr.rows()] for rr in res[:N_GT]])
    r = recall(ids, d_l2, kth_l2)
    print(f"[main] execute_batch l2 exact B=256: {256 / dt_b:.1f} QPS "
          f"(median of {REPS} batches, {[round(t * 1e3, 3) for t in times]} "
          f"ms), recall@10 {r} [{card}]")
    check(len(res) == 256 and r >= 0.99, f"execute_batch recall {r}")
    check(ps._knn._x.is_cuda, "the corpus is not on the card")

    sql = ("SELECT id, {fn}(emb, ?) AS d FROM t ORDER BY {fn}(emb, ?) LIMIT 10")
    sets = [(v, v) for v in queries]
    modes = [("l2", True, 0.99), ("l2", False, 0.95), ("cosine", False, 0.95)]
    for metric, exact, need in modes:
        bp = ctx.prepare(sql.format(fn=f"{metric}_distance"))
        bp.execute_batch_block(sets, exact=exact)              # warm
        before = ft.flash_group_minima.launches
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            res = bp.execute_batch_block(sets, exact=exact)
            times.append(time.perf_counter() - t0)
        dt_b = float(np.median(times))
        grew = ft.flash_group_minima.launches - before
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
              f"max |score - f64| {err}, flash launches {grew} [{card}]")
        check(r >= need, f"{metric} exact={exact}: recall {r} < {need}")
        check(err <= 1e-3 * max(1.0, float(np.abs(true).max())),
              f"{metric} exact={exact}: scores off by {err}")
        if exact:
            check(grew == 0, "the exact mode launched the flash kernel")
        else:
            check(grew > 0, "approximate mode did not launch the flash kernel")
            check(bp._knn._flash_state()[0].is_cuda,
                  "flash corpus not on the card")

    # a batch of one 256-query chunk runs the exact program in both modes
    bp = ctx.prepare(sql.format(fn="l2_distance"))
    before = ft.flash_group_minima.launches
    t0 = time.perf_counter()
    res = bp.execute_batch_block(sets[:256], exact=False)
    dt_b = time.perf_counter() - t0
    grew = ft.flash_group_minima.launches - before
    ids, _ = _ids_scores(res, 256)
    r = recall(ids[:N_GT], d_l2, kth_l2)
    print(f"[main] execute_batch_block l2 exact=False B=256: {dt_b * 1e3:.3f} ms "
          f"(one batch), recall@10 {r}, flash launches {grew} [{card}]")
    check(grew == 0, "a one-chunk approximate batch launched the flash kernel")
    check(r >= 0.99, f"one-chunk approximate batch: recall {r}")


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import databend_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    kern = phase_kernels(card)
    if "--diagnose" in sys.argv[1:]:
        diagnose_flash(card)
    launches = phase_main_path(card, "--profile" in sys.argv[1:])
    check(launches > 0, "the main path launched flash_group_minima no time")
    phase_cluster(card)
    phase_suites(card)
    check_standalone()

    err = max(v[0] for v in kern.values())
    # the serving chunk shape
    _, ms, plain_ms, bound_ms, bound_by = kern[("l2", 256, DIM)]
    print(json.dumps({"kernels": [{
        "name": "flash_group_minima", "route": "cuda",
        "source": "databend_tpu_torch/csrc/flash_group_minima.cu",
        "replaces": "databend_tpu/ops/flash_topk.py:94",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
