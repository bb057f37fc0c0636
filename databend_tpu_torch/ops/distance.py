"""Batched vector distances (port of ``databend_tpu/ops/distance.py``).

Same contract as the reference: every pairwise function maps
``[B, d] x [N, d] -> [B, N]`` distances (smaller = closer, except
``inner_product``, which returns the raw dot product like the SQL function);
``compute_dtype=torch.bfloat16`` rounds both operands to bf16 and accumulates
in f32, ``torch.float32`` runs full f32 (TF32 is off, see ``backend``). The
matrix products are ``torch.matmul``: the reference leaves them to XLA,
outside any Pallas kernel. L1 has no matmul form and runs in N-chunks.
"""

from __future__ import annotations

from typing import Optional

import torch

VALID_METRICS = ("cosine", "l2", "l2_sq", "l1", "ip")

_EPS = 1e-30


def normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2-normalize rows; zero vectors stay zero (cosine preprocessing)."""
    n = torch.sqrt(torch.sum(x.float() ** 2, dim=axis, keepdim=True))
    return (x / torch.clamp_min(n, _EPS)).to(x.dtype)


def _dot(q: torch.Tensor, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    # operands rounded to compute_dtype, products summed in f32 (the
    # reference's preferred_element_type=float32)
    qc = q.to(compute_dtype).float()
    xc = x.to(compute_dtype).float()
    return torch.matmul(qc, xc.T)


def inner_product(q: torch.Tensor, x: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Pairwise dot products ``[B, N]`` (SQL ``inner_product``)."""
    return _dot(q, x, compute_dtype)


def cosine_distance(q: torch.Tensor, x: torch.Tensor,
                    compute_dtype=torch.float32,
                    x_normalized: bool = False) -> torch.Tensor:
    """``1 - cos(q, x)`` pairwise."""
    qn = normalize(q)
    xn = x if x_normalized else normalize(x)
    return 1.0 - _dot(qn, xn, compute_dtype)


def l2_distance_squared(q: torch.Tensor, x: torch.Tensor,
                        compute_dtype=torch.float32,
                        x_sq_norms: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``||q - x||^2`` via ``|q|^2 - 2 q.x + |x|^2``, clamped at 0.

    ``x_sq_norms`` (precomputed ``[N]``) amortizes the norm over queries."""
    q32 = q.float()
    qq = torch.sum(q32 * q32, dim=-1, keepdim=True)          # [B, 1]
    if x_sq_norms is None:
        x32 = x.float()
        x_sq_norms = torch.sum(x32 * x32, dim=-1)            # [N]
    qx = _dot(q, x, compute_dtype)                           # [B, N]
    return torch.clamp_min(qq - 2.0 * qx + x_sq_norms[None, :], 0.0)


def l2_distance(q: torch.Tensor, x: torch.Tensor, compute_dtype=torch.float32,
                x_sq_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.sqrt(l2_distance_squared(q, x, compute_dtype, x_sq_norms))


def l1_distance(q: torch.Tensor, x: torch.Tensor,
                chunk: int = 1024) -> torch.Tensor:
    """Manhattan distance over N-chunks of ``chunk`` rows, so peak memory is
    ``B*chunk*d`` instead of ``B*N*d``. A ragged last chunk is fine."""
    q32 = q.float()
    parts = [torch.sum(torch.abs(q32[:, None, :] - xi.float()[None, :, :]),
                       dim=-1)
             for xi in torch.split(x, chunk)]
    return torch.cat(parts, dim=1)


def pairwise_distance(q: torch.Tensor, x: torch.Tensor, metric: str,
                      compute_dtype=torch.float32,
                      x_sq_norms: Optional[torch.Tensor] = None,
                      x_normalized: bool = False) -> torch.Tensor:
    """Dispatch on metric name; returns ``[B, N]`` distances."""
    if metric == "cosine":
        return cosine_distance(q, x, compute_dtype, x_normalized=x_normalized)
    if metric == "l2":
        return l2_distance(q, x, compute_dtype, x_sq_norms)
    if metric == "l2_sq":
        return l2_distance_squared(q, x, compute_dtype, x_sq_norms)
    if metric == "l1":
        return l1_distance(q, x)
    if metric == "ip":
        return -_dot(q, x, compute_dtype)
    raise ValueError(f"unknown metric {metric!r}; expected one of {VALID_METRICS}")


def rowwise_distance(a: torch.Tensor, b: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """``[N, d] x [N, d] -> [N]`` row-aligned distances (SQL scalar
    semantics)."""
    a32 = a.float()
    b32 = b.float()
    if metric == "cosine":
        num = torch.sum(a32 * b32, dim=-1)
        den = torch.sqrt(torch.sum(a32 * a32, dim=-1)
                         * torch.sum(b32 * b32, dim=-1))
        return 1.0 - num / torch.clamp_min(den, _EPS)
    if metric == "l2":
        return torch.sqrt(torch.sum((a32 - b32) ** 2, dim=-1))
    if metric == "l2_sq":
        return torch.sum((a32 - b32) ** 2, dim=-1)
    if metric == "l1":
        return torch.sum(torch.abs(a32 - b32), dim=-1)
    if metric == "ip":
        return torch.sum(a32 * b32, dim=-1)
    raise ValueError(f"unknown metric {metric!r}")
