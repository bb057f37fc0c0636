"""Flash top-k: fused distance matmul + group-min scan, then exact re-rank
(port of ``databend_tpu/ops/flash_topk.py``).

``flash_group_minima`` scores the corpus tile by tile in bf16 and keeps, per
query, only the minimum of every lane-aligned group of rows (row
``t*tile + g*L + lane`` is in group ``(t, lane)``): ``[ntiles, B, L]``, about
``L/tile`` of the full score matrix. ``flash_topk`` then picks the best
``shortlist`` groups, expands them to their ``tile/L`` member rows and
re-scores those exactly in f32. A true top-k row is lost only if its group
has ``shortlist`` better groups.

On a CUDA tensor ``flash_group_minima`` launches the hand-written Hopper
kernel ``csrc/flash_group_minima.cu`` (a TMA ring feeding ``wgmma``, work
items of 128 queries on a persistent grid) or raises; on a CPU tensor it
runs the plain PyTorch version ``_flash_group_minima_plain``, which has the
same contract and group membership.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _cuda
from .distance import _dot
from .topk import topk_smallest_lowest_index

_KERNEL_LANES = 128   # the CUDA kernel's L
_TMA_ALIGN = 16       # bytes: base address of a tensor map or bulk copy
_METRIC_SCALE = {"l2": 2.0, "ip": 1.0}


def _check_inputs(q, x_bf16, norms, metric, tile, buckets):
    if metric not in _METRIC_SCALE:
        raise ValueError(f"flash_group_minima: metric {metric!r} not in "
                         f"{tuple(_METRIC_SCALE)}")
    if q.ndim != 2 or x_bf16.ndim != 2 or norms.ndim != 1:
        raise ValueError("flash_group_minima: want q [B, D], x [N, D], "
                         "norms [N]")
    n, d = x_bf16.shape
    if q.shape[1] != d or norms.shape[0] != n:
        raise ValueError(f"flash_group_minima: shapes q {tuple(q.shape)}, "
                         f"x {tuple(x_bf16.shape)}, norms {tuple(norms.shape)}")
    if q.dtype != torch.float32 or x_bf16.dtype != torch.bfloat16 \
            or norms.dtype != torch.float32:
        raise TypeError("flash_group_minima: want q f32, x bf16, norms f32; "
                        f"got {q.dtype}, {x_bf16.dtype}, {norms.dtype}")
    if tile % buckets or n % tile:
        raise ValueError(f"flash_group_minima: need N % tile == 0 and "
                         f"tile % buckets == 0 (N={n}, tile={tile}, "
                         f"buckets={buckets}); pad with pad_for_flash")
    if not (q.device == x_bf16.device == norms.device):
        raise ValueError("flash_group_minima: inputs on different devices")


def _flash_group_minima_plain(q: torch.Tensor, x_bf16: torch.Tensor,
                              norms: torch.Tensor, metric: str = "l2",
                              tile: int = 16384,
                              buckets: int = 128) -> torch.Tensor:
    """Plain PyTorch version: bf16 operands, f32 sums, then the group min."""
    b = q.shape[0]
    ntiles = x_bf16.shape[0] // tile
    dots = _dot(q, x_bf16, torch.bfloat16)
    scores = norms[None, :] - _METRIC_SCALE[metric] * dots          # [B, N]
    minima = scores.reshape(b, ntiles, tile // buckets, buckets).amin(2)
    return minima.permute(1, 0, 2).contiguous()                     # [T, B, L]


def flash_group_minima(q: torch.Tensor, x_bf16: torch.Tensor,
                       norms: torch.Tensor, metric: str = "l2",
                       tile: int = 16384, buckets: int = 128) -> torch.Tensor:
    """``[ntiles, B, L]`` group minima of ``norms - c * q.x`` (see module doc).

    q ``[B, D]`` f32; x_bf16 ``[N, D]`` bf16 with ``N % tile == 0`` (pad with
    pad_for_flash); norms ``[N]`` f32: exact ``|x|^2`` for l2 (the per-query
    ``|q|^2`` is dropped), zeros for ip, +inf on pad rows."""
    _check_inputs(q, x_bf16, norms, metric, tile, buckets)
    if q.device.type == "cpu":
        return _flash_group_minima_plain(q, x_bf16, norms, metric, tile,
                                         buckets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_group_minima: no kernel for {q.device}")
    b, d = q.shape
    n = x_bf16.shape[0]
    if buckets != _KERNEL_LANES or d % 16 or b < 1:
        raise ValueError(f"flash_group_minima: the CUDA kernel needs "
                         f"buckets == {_KERNEL_LANES}, D % 16 == 0 and "
                         f"B >= 1 (buckets={buckets}, D={d}, B={b})")
    # the kernel's A operand: bf16(-c * q), which is -c * bf16(q) for c = 1, 2
    qn = torch.empty((b, d), dtype=torch.bfloat16, device=q.device)
    torch.mul(q, -_METRIC_SCALE[metric], out=qn)
    _check_tma_operands(qn=qn, x_bf16=x_bf16, norms=norms)
    lib = _launcher()
    out = torch.empty((n // tile, b, buckets), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_group_minima_launch(
            qn.data_ptr(), x_bf16.data_ptr(), norms.data_ptr(), out.data_ptr(),
            b, n, d, tile, stream)
    if err:
        msg = lib.flash_group_minima_error_string(err).decode()
        raise RuntimeError(f"flash_group_minima launch failed: {msg} ({err})")
    flash_group_minima.launches += 1
    return out


flash_group_minima.launches = 0


def _check_tma_operands(**tensors: torch.Tensor) -> None:
    """The kernel reads its operands with TMA (tensor maps and bulk copies):
    each must be contiguous and start at a multiple of 16 bytes."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"flash_group_minima: {name} must be contiguous")
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"flash_group_minima: {name} must start at a "
                             f"multiple of {_TMA_ALIGN} bytes")


# the C interface of csrc/flash_group_minima.cu
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]     # qn, x, norms, out; B, N, D, tile; stream


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _cuda.load("flash_group_minima")
    lib.flash_group_minima_launch.argtypes = _LAUNCH_ARGTYPES
    lib.flash_group_minima_launch.restype = ctypes.c_int
    lib.flash_group_minima_error_string.argtypes = [ctypes.c_int]
    lib.flash_group_minima_error_string.restype = ctypes.c_char_p
    return lib


def pad_for_flash(x: torch.Tensor, norms: torch.Tensor, tile: int = 4096):
    """Pad (corpus, norms) so ``N % tile == 0``; pad rows are zero with +inf
    norms, so they never win a group min. Returns (x, norms, n_valid)."""
    n = x.shape[0]
    rem = (-n) % tile
    if rem == 0:
        return x, norms, n
    xp = torch.cat([x, x.new_zeros((rem, x.shape[1]))])
    np_ = torch.cat([norms, norms.new_full((rem,), float("inf"))])
    return xp, np_, n


def flash_topk(q: torch.Tensor, x_bf16: torch.Tensor, norms: torch.Tensor,
               x_f32: torch.Tensor, k: int, metric: str = "l2",
               tile: int = 16384, buckets: int = 128, shortlist: int = 0,
               n_valid: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + exact re-rank -> (f32 distances ``[B, k]`` ascending,
    row ids ``[B, k]``): squared l2, or ``-dot`` for ip.

    ``shortlist``: number of winning groups re-ranked exactly (default 2k).
    ``n_valid``: rows at or past it are padding and are masked out of the
    re-rank; ``x_f32`` must hold at least the ``n_valid`` real rows.
    ``x_bf16`` may carry zero columns past ``q``'s width (the CUDA kernel
    needs ``D % 16 == 0``); they change no dot product."""
    if shortlist <= 0:
        shortlist = 2 * k
    b, d = q.shape
    n = x_bf16.shape[0]
    group = tile // buckets
    q32 = q.float()
    qk = q32
    if x_bf16.shape[1] > d:
        qk = torch.nn.functional.pad(q32, (0, x_bf16.shape[1] - d))
    minima = flash_group_minima(qk.contiguous(), x_bf16, norms, metric, tile,
                                buckets)                         # [T, B, L]
    flat = minima.permute(1, 0, 2).reshape(b, -1)                # [B, T*L]
    _, win = topk_smallest_lowest_index(flat, shortlist)        # [B, S]
    # group (tile_idx, lane) -> its tile/L member rows
    tile_idx = win // buckets
    lane = win % buckets
    member = torch.arange(group, device=q.device)
    cand = (tile_idx[:, :, None] * tile + member[None, None, :] * buckets
            + lane[:, :, None]).reshape(b, shortlist * group)
    cand = torch.clamp_max(cand, min(n, x_f32.shape[0]) - 1)

    cand_vecs = x_f32[cand]                                      # [B, S*G, D]
    if metric == "l2":
        # in place: the [B, S*G, D] gather is the largest buffer of the call
        exact = cand_vecs.sub_(q32[:, None, :]).square_().sum(-1)
    else:
        exact = -torch.einsum("bsd,bd->bs", cand_vecs, q32)
    if n_valid is not None:
        exact = exact.masked_fill(cand >= n_valid, float("inf"))
    vals, pos = topk_smallest_lowest_index(exact, k)
    return vals, torch.gather(cand, 1, pos)
