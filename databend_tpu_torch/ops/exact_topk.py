"""The distance epilogue and the tie-rule selection of exact KNN.

The reference's exact programs (``databend_tpu/storage/fuse/table.py``,
``exact_topk``; ``databend_tpu/service/prepared.py``, ``_scan_topk_program``
and ``_scan_topk_filtered_program``; ``databend_tpu/ops/topk.py``,
``chunked_topk_smallest``) score a query block against the corpus, mask the
pad rows (and, filtered, the rows a query's WHERE drops) to +inf by index,
and take ``jax.lax.top_k(-d, k)``. XLA fuses that; eager PyTorch makes the
``[b, N]`` block three more times and selects it with sorts.
``exact_topk_select`` takes the f32 product block that ``torch.matmul``
makes (``ops.distance.pairwise_product``: the reference computes ``q.x`` as
a plain XLA dot) and, in one pass over it, forms each distance as
``ops.distance.finish_distance`` does, masks and selects.

``exact_topk_select(qx, qq, xx, metric, k, n_valid, keep)`` returns the
k smallest distances per query and their positions, in ``lax.top_k(-d,
k)``'s order: equal distances by ascending position, -0.0 against +0.0 as
``ops.topk._order_key`` orders ``-d``. Columns at or past ``n_valid`` and
the cells where ``keep`` (bool ``[b, N]`` or ``[1, N]``) is False score +inf
and are still ranked by position, so a LIMIT past the rows that count
returns what the plain path returns.

On a CUDA tensor the wrapper launches ``csrc/exact_topk_select.cu`` or
raises; on a CPU tensor it runs the plain version
``_exact_topk_select_plain``: ``finish_distance``, the masks and
``ops.topk.topk_smallest_lowest_index``. Above ``MAX_K`` the card runs that
same composition (a route by shape, like ``impact_bm25_topk``'s: a cut
keeps at most 128 keys); nothing falls back on a failure. l1 has no
product form: :func:`exact_topk`, the function the exact paths call,
routes it to ``l1_distance`` and the tie-rule top-k.

The kernel runs a block of eight warps a (query, segment) with one buffer
of keys; ``_plan`` cuts each query's row into segments.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _cuda
from .distance import finish_distance, l1_distance, pairwise_product
from .topk import topk_smallest_lowest_index

MAX_K = 128               # the kernel's largest k (csrc MAX_K)
STEP = 256                # positions a warp reads an iteration (csrc STEP)
ROUND = 8 * STEP          # positions a block reads a round (csrc ROUND)
BLOCKS_A_SM = 4           # blocks an SM holds (csrc launch bounds)
MIN_SEGMENT = 4 * ROUND   # the shortest segment the plan cuts
SMS = 132                 # SMs of an H100 (the plan reads the card's)
METRICS = {"l2": 0, "l2_sq": 1, "cosine": 2, "ip": 3}
INF = float("inf")


class Plan(NamedTuple):
    """How the kernel runs a shape: each query's N positions in ``ways``
    segments of ``span`` positions (a multiple of ``ROUND``), a block of
    eight warps each."""
    span: int
    ways: int


def _plan(b: int, n: int, sms: int = SMS) -> Plan:
    """As many segments a query as keep the batch within the blocks the
    card holds at once (one wave: a block is a long stream, and a second,
    partial wave would idle the rest of the card), at least one and none
    shorter than ``MIN_SEGMENT``."""
    ways = max(1, min(sms * BLOCKS_A_SM // b, -(-n // MIN_SEGMENT)))
    seg = -(-(-(-n // ways)) // ROUND) * ROUND
    return Plan(seg, -(-n // seg))


def _scratch_words(plan: Plan, b: int, k: int) -> int:
    """8-byte words of the kernel's scratch: with ways > 1 the segments'
    lists and counts, a threshold and a ticket per query; none for ways =
    1."""
    return 0 if plan.ways == 1 else b * (plan.ways * (k + 1) + 2)


def _check(qx, qq, xx, metric, k, n_valid, keep):
    if metric not in METRICS:
        raise ValueError(f"exact_topk_select: no product form for {metric!r};"
                         f" want one of {tuple(METRICS)}")
    if qx.ndim != 2 or qx.dtype != torch.float32:
        raise TypeError("exact_topk_select: want qx a [b, N] float32 block, "
                        f"got {qx.dtype} {tuple(qx.shape)}")
    b, n = qx.shape
    if not qx.is_contiguous():
        raise ValueError("exact_topk_select: qx must be contiguous")
    if n >= 1 << 32:
        raise ValueError(f"exact_topk_select: N = {n} needs N < 2^32")
    if not 1 <= k <= n:
        raise ValueError(f"exact_topk_select: want 1 <= k <= N, got k={k}, "
                         f"N={n}")
    if n_valid is not None and not 0 <= n_valid:
        raise ValueError(f"exact_topk_select: n_valid {n_valid} < 0")
    norms = {"qq": (qq, b), "xx": (xx, n)}
    for name, (t, size) in norms.items():
        if metric not in ("l2", "l2_sq"):
            continue
        if t is None or t.shape != (size,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"exact_topk_select: {metric} wants {name} a "
                             f"contiguous [{size}] float32 tensor")
    if keep is not None and (keep.dtype != torch.bool or keep.ndim != 2
                             or keep.shape[0] not in (1, b)
                             or keep.shape[1] != n
                             or not keep.is_contiguous()):
        raise ValueError(f"exact_topk_select: want keep a contiguous bool "
                         f"[{b}, {n}] or [1, {n}] mask")
    used = [qx] + [t for t in (qq, xx, keep) if t is not None]
    if any(t.device != qx.device for t in used):
        raise ValueError("exact_topk_select: operands on different devices")


def _mask(d, n_valid, keep):
    """``d`` with the pad columns and the dropped cells at +inf, in
    place."""
    if n_valid is not None and n_valid < d.shape[1]:
        d[:, n_valid:] = INF
    if keep is not None:
        d.masked_fill_(~keep, INF)
    return d


def _masked_distance(qx, qq, xx, metric, n_valid, keep):
    return _mask(finish_distance(qx, qq, xx, metric), n_valid, keep)


def _exact_topk_select_plain(qx: torch.Tensor, qq: Optional[torch.Tensor],
                             xx: Optional[torch.Tensor], metric: str, k: int,
                             n_valid: Optional[int] = None,
                             keep: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the masked distances, then the tie-rule
    top-k."""
    return topk_smallest_lowest_index(
        _masked_distance(qx, qq, xx, metric, n_valid, keep), k)


def exact_topk_select(qx: torch.Tensor, qq: Optional[torch.Tensor],
                      xx: Optional[torch.Tensor], metric: str, k: int,
                      n_valid: Optional[int] = None,
                      keep: Optional[torch.Tensor] = None):
    """The ``k`` smallest distances per query of the product block ``qx
    [b, N]`` and their positions -> (vals ``[b, k]`` f32, positions ``[b,
    k]`` int64), in ``lax.top_k(-d, k)``'s order (see the module doc).
    ``qq [b]`` and ``xx [N]``: the squared norms (l2 and l2_sq only);
    ``n_valid``: the columns that are not padding; ``keep``: the cells that
    pass the query's filter. ``1 <= k <= N``. Above ``MAX_K`` the masked
    distances and the tie-rule top-k run apart."""
    _check(qx, qq, xx, metric, k, n_valid, keep)
    if qx.device.type == "cpu":
        return _exact_topk_select_plain(qx, qq, xx, metric, k, n_valid, keep)
    if k > MAX_K:
        return topk_smallest_lowest_index(
            _masked_distance(qx, qq, xx, metric, n_valid, keep), k)
    if qx.device.type != "cuda":
        raise ValueError(f"exact_topk_select: no kernel for {qx.device}")
    b, n = qx.shape
    vals, pos = _launch(_launcher(), qx, qq, xx, metric, k, n_valid, keep,
                        _plan(b, n, _cuda.sm_count(qx.device)))
    exact_topk_select.launches += 1
    return vals, pos


def _check_plan(plan: Plan, b: int, n: int):
    """Raise unless the kernel takes ``plan`` for a ``[b, n]`` block (the
    C launcher checks the same): segments of whole rounds (ROUND
    positions) that cover a row with ``ways`` of them, and a grid of ``b x
    ways`` blocks that fits."""
    if plan.span < 1 or plan.span % ROUND \
            or plan.ways != -(-n // plan.span) or b * plan.ways >= 1 << 31:
        raise ValueError(f"exact_topk_select: no kernel plan {plan} for a "
                         f"[{b}, {n}] block")


def _launch(lib, qx, qq, xx, metric, k, n_valid, keep, plan):
    """Launch ``lib``'s kernel on checked CUDA operands under ``plan``;
    returns (vals, positions)."""
    b, n = qx.shape
    _check_plan(plan, b, n)
    dev = qx.device
    words = _scratch_words(plan, b, k)
    part = torch.empty(words, dtype=torch.int64, device=dev) if words \
        else None
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    pos = torch.empty((b, k), dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (qx, xx) if t is not None]
    vec = n % 4 == 0 and all(p % 16 == 0 for p in ptrs) \
        and (keep is None or keep.data_ptr() % 4 == 0)
    keep_ld = 0 if keep is None or keep.shape[0] == 1 else n
    args = (qx.data_ptr(), None if qq is None else qq.data_ptr(),
            None if xx is None else xx.data_ptr(),
            None if keep is None else keep.data_ptr(), keep_ld,
            METRICS[metric], n, n if n_valid is None else min(n_valid, n), b,
            k, plan.span, plan.ways, int(vec),
            None if part is None else part.data_ptr(), vals.data_ptr(),
            pos.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.exact_topk_select_launch(*args, stream)
    if err:
        msg = lib.exact_topk_select_error_string(err).decode()
        raise RuntimeError(f"exact_topk_select launch failed: {msg} ({err})")
    return vals, pos


exact_topk_select.launches = 0


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
               compute_dtype=torch.float32,
               x_sq_norms: Optional[torch.Tensor] = None,
               x_normalized: bool = False, n_valid: Optional[int] = None,
               keep: Optional[torch.Tensor] = None):
    """Exact top-k of ``q [b, d]`` against ``x [N, d]`` -> (distances ``[b,
    k]``, positions ``[b, k]`` int64): ``pairwise_product``, then
    ``exact_topk_select``. l1, which has no product form, takes
    ``l1_distance``, the masks and the tie-rule top-k (a route by metric).
    Operands as ``ops.distance.pairwise_distance`` and
    :func:`exact_topk_select`."""
    if metric == "l1":
        return topk_smallest_lowest_index(
            _mask(l1_distance(q, x), n_valid, keep), k)
    qx, qq, xx = pairwise_product(q, x, metric, compute_dtype, x_sq_norms,
                                  x_normalized)
    return exact_topk_select(qx, qq, xx, metric, k, n_valid, keep)


# the C interface of csrc/exact_topk_select.cu: qx, qq, xx, keep; keep's row
# stride; metric; N, n_valid; b, k; segment; ways; vec; part, vals, ids;
# stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
_HANDSHAKE = {"exact_topk_select_max_k": MAX_K,
              "exact_topk_select_round": ROUND}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of the kernel's source and check
    that it agrees with this module on MAX_K and ROUND."""
    lib.exact_topk_select_launch.argtypes = _LAUNCH_ARGTYPES
    lib.exact_topk_select_empty.argtypes = [ctypes.c_void_p]
    lib.exact_topk_select_error_string.argtypes = [ctypes.c_int]
    lib.exact_topk_select_error_string.restype = ctypes.c_char_p
    for name, want in _HANDSHAKE.items():
        getattr(lib, name).argtypes = []
        if getattr(lib, name)() != want:
            raise RuntimeError("csrc/exact_topk_select.cu and "
                               f"ops/exact_topk.py disagree on {name}")
    return lib


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    return _bind(_cuda.load("exact_topk_select"))
