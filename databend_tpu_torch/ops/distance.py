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
    return finish_distance(*pairwise_product(
        q, x, "cosine", compute_dtype, x_normalized=x_normalized), "cosine")


def l2_distance_squared(q: torch.Tensor, x: torch.Tensor,
                        compute_dtype=torch.float32,
                        x_sq_norms: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``||q - x||^2`` via ``|q|^2 - 2 q.x + |x|^2``, clamped at 0.

    ``x_sq_norms`` (precomputed ``[N]``) amortizes the norm over queries."""
    return finish_distance(*pairwise_product(
        q, x, "l2_sq", compute_dtype, x_sq_norms), "l2_sq")


def l2_distance(q: torch.Tensor, x: torch.Tensor, compute_dtype=torch.float32,
                x_sq_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    return finish_distance(*pairwise_product(
        q, x, "l2", compute_dtype, x_sq_norms), "l2")


def pairwise_product(q: torch.Tensor, x: torch.Tensor, metric: str,
                     compute_dtype=torch.float32,
                     x_sq_norms: Optional[torch.Tensor] = None,
                     x_normalized: bool = False):
    """The matrix product of a product-form metric and the norms its
    distance needs: ``(qx [B, N] f32, qq [B] or None, xx [N] or None)``.
    l2 and l2_sq: ``q.x`` and both squared norms (``x_sq_norms`` when
    given); cosine: the product of the normalised rows (``x`` already
    normalised when ``x_normalized``); ip: ``q.x``. l1 has no product form.
    :func:`finish_distance` turns it into the distances."""
    if metric in ("l2", "l2_sq"):
        q32 = q.float()
        qq = torch.sum(q32 * q32, dim=-1)                    # [B]
        if x_sq_norms is None:
            x32 = x.float()
            x_sq_norms = torch.sum(x32 * x32, dim=-1)        # [N]
        return _dot(q, x, compute_dtype), qq, x_sq_norms
    if metric == "cosine":
        qn = normalize(q)
        xn = x if x_normalized else normalize(x)
        return _dot(qn, xn, compute_dtype), None, None
    if metric == "ip":
        return _dot(q, x, compute_dtype), None, None
    raise ValueError(f"pairwise_product: no product form for {metric!r}")


def finish_distance(qx: torch.Tensor, qq: Optional[torch.Tensor],
                    xx: Optional[torch.Tensor], metric: str) -> torch.Tensor:
    """The ``[B, N]`` distances from :func:`pairwise_product`'s output, each
    operation rounded to f32 in this order: l2_sq ``clamp_min((qq - 2 qx) +
    xx, 0)``, l2 its ``sqrt``, cosine ``1 - qx``, ip ``-qx``
    (``csrc/exact_topk_select.cu`` repeats it bit for bit)."""
    if metric in ("l2", "l2_sq"):
        d = torch.clamp_min(qq[:, None] - 2.0 * qx + xx[None, :], 0.0)
        return torch.sqrt(d) if metric == "l2" else d
    if metric == "cosine":
        return 1.0 - qx
    if metric == "ip":
        return -qx
    raise ValueError(f"finish_distance: no product form for {metric!r}")


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
    if metric == "l1":
        return l1_distance(q, x)
    if metric in ("l2", "l2_sq", "cosine", "ip"):
        return finish_distance(*pairwise_product(
            q, x, metric, compute_dtype, x_sq_norms, x_normalized), metric)
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
