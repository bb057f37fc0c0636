"""The yardstick of the rooflines: published peaks of one NVIDIA H100 and
the least time a kernel's work could take on it.

Frozen copies of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``F32_FLOPS_PER_S``, ``BF16_FLOPS_PER_S`` and ``INT32_OPS_PER_S`` and of its
``exact_bound``, so that later changes to the port or to ``chip_smoke.py``
do not move the benchmark's rooflines. The rates are NVIDIA's data sheet
for the SXM part (dense, no sparsity) at its 700 W limit; a run prints the
card's power limit beside them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12             # HBM3, data sheet
F32_FLOPS_PER_S = 67e12               # f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12             # dense bf16 tensor-core peak
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock


def bound(nbytes: float, ops_seconds: float) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the time to move
    ``nbytes`` once at the memory rate and ``ops_seconds``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= ops_seconds \
        else (ops_seconds, "operations")


def f32_gemm_bound(b: int, n: int, d: int) -> tuple:
    """The least time of a ``[b, d] x [d, n]`` f32 product: its 2 b n d
    FLOPs at the f32 peak, or one read of both operands and one write of
    the ``[b, n]`` f32 block, whichever is larger."""
    return bound(4.0 * (b * d + n * d + b * n), 2.0 * b * n * d / F32_FLOPS_PER_S)


def exact_select_bound(b: int, n: int, k: int, l2: bool = True,
                       keep_bytes: int = 0) -> tuple:
    """The least time of one ``exact_topk_select`` launch over a ``[b, n]``
    product block (``chip_smoke.exact_bound``): one read of the block, of
    the norms (l2: ``b`` and ``n`` f32) and of the mask, and one write of
    the ``[b, k]`` values and int64 positions at the memory rate, or its
    f32 operations (at most five a cell: the l2 epilogue) at the f32 peak
    and one key compare a cell at the int32 rate, whichever is larger."""
    nbytes = 4 * b * n + 12 * b * k + (4 * (b + n) if l2 else 0) + keep_bytes
    return bound(nbytes, b * n * (5 / F32_FLOPS_PER_S + 1 / INT32_OPS_PER_S))
