"""Scalar quantization (SQ-u8) scoring (port of
``databend_tpu/ops/quantization.py``).

Reference: EncodedVectorsU8 (src/query/storages/common/index/src/hnsw_index/
quantization/encoded_vectors_u8.rs:33-427) — per-index (alpha, offset)
affine u8 encoding with optional quantile clipping. Values are centered to
int8 (c = u8 - 128), so scoring is an int8 x int8 product summed exactly in
int32, plus rank-1 correction terms from per-vector element sums:

    x ~ alpha * u + offset,  u = c + 128
    dot(x, y) = alpha^2 * (c_x . c_y)
              + alpha * (alpha*128 + offset) * (s_x + s_y)
              + d * (alpha*128 + offset)^2
  with s = sum(c).

The int8 product takes one exact route on every device (:func:`int8_dot`):
torch's CPU int8 ``matmul`` wraps and CUDA ``torch.matmul`` has no int8
path, so the codes multiply as f32 in K-slices of at most ``K_SLICE``
columns, where every partial sum (|c| <= 128) stays below 2^24, and the
slices add in int32. The selections take the reference's tie rule
(``ops.topk``); its ``approx_min_k`` is the same exact selection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import backend
from .topk import topk_smallest_lowest_index

# columns of one f32 slice of the int8 product: 1,024 x 128 x 128 = 2^24
K_SLICE = 1024


class SQ8Meta(NamedTuple):
    alpha: float
    offset: float
    dim: int


class SQ8Corpus(NamedTuple):
    codes: torch.Tensor      # [N, d] int8 (centered)
    sums: torch.Tensor       # [N] f32: sum of centered codes per row
    sq_norms: torch.Tensor   # [N] f32: exact |x|^2 of the ORIGINAL vectors
    # [N] f32: sq_norms - 2*alpha*beta*sums, so the L2 ranking key is ONE
    # multiply-add over the int8 product:
    #   rank = -2*alpha^2 * idot + rank_corr   (+ per-query constants that
    # don't affect per-row selection).
    rank_corr: torch.Tensor
    meta: SQ8Meta


def encode(x: np.ndarray, quantile: float = 0.99) -> SQ8Corpus:
    """Fit (alpha, offset) on [lo, hi] quantiles (reference quantile.rs)
    and encode to centered int8 on :func:`backend.device`."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if quantile >= 1.0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo = float(np.quantile(x, 1.0 - quantile))
        hi = float(np.quantile(x, quantile))
    if hi <= lo:
        hi = lo + 1e-6
    alpha = (hi - lo) / 255.0
    offset = lo
    u = np.clip(np.rint((x - offset) / alpha), 0, 255).astype(np.int32)
    c = (u - 128).astype(np.int8)
    sums = c.astype(np.float32).sum(axis=1)
    sq = (x.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    beta = alpha * 128.0 + offset
    rank_corr = sq - 2.0 * alpha * beta * sums
    return SQ8Corpus(backend.to_device(c), backend.to_device(sums),
                     backend.to_device(sq), backend.to_device(rank_corr),
                     SQ8Meta(alpha, offset, d))


def encode_query(q: np.ndarray, meta: SQ8Meta
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode queries once, then score against the whole corpus
    (reference encode_query / score_point split)."""
    q = np.asarray(q, np.float32)
    u = np.clip(np.rint((q - meta.offset) / meta.alpha), 0, 255).astype(np.int32)
    c = (u - 128).astype(np.int8)
    return (backend.to_device(c),
            backend.to_device(c.astype(np.float32).sum(axis=1)))


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.T`` of int8 codes ``a [B, d]``, ``b [N, d]`` (|c| <=
    128) -> int32 ``[B, N]``: f32 products of K-slices of at most
    ``K_SLICE`` columns, each exact below 2^24, added in int32."""
    out = None
    for s in range(0, a.shape[1], K_SLICE):
        part = torch.matmul(a[:, s:s + K_SLICE].float(),
                            b[:, s:s + K_SLICE].float().T).to(torch.int32)
        out = part if out is None else out + part
    return out


def _dot_scores(qc, qs, codes, sums, alpha: float, offset: float, dim: int):
    idot = int8_dot(qc, codes)                                 # [B, N] int32
    beta = alpha * 128.0 + offset
    return (alpha * alpha * idot.float()
            + alpha * beta * (qs[:, None] + sums[None, :])
            + dim * beta * beta)


def approx_dot(q_codes, q_sums, corpus: SQ8Corpus) -> torch.Tensor:
    """Pairwise approximate dot products `[B, N]` from int8 codes."""
    m = corpus.meta
    return _dot_scores(q_codes, q_sums, corpus.codes, corpus.sums,
                       m.alpha, m.offset, m.dim)


def _topk_l2_device(qj, q_codes, codes, rank_corr, x_f32,
                    k: int, s: int, alpha: float, offset: float, dim: int,
                    rerank: bool):
    # selection phase: the exact int8 product + ONE multiply-add as the
    # ranking key. Per-query constants (|q|^2, the alpha*beta*q_sums term)
    # shift every row of a query equally, so they are dropped from the
    # selection and only the exact re-rank produces true distances.
    idot = int8_dot(q_codes, codes)                            # [B, N]
    rank = (-2.0 * alpha * alpha) * idot.float() + rank_corr[None, :]
    if not rerank:
        vals, ids = topk_smallest_lowest_index(rank, k)
        # restore true squared distances for the returned values
        qq = torch.sum(qj * qj, dim=1, keepdim=True)
        beta = alpha * 128.0 + offset
        qs = torch.sum(q_codes.float(), dim=1, keepdim=True)
        return (vals + qq - 2.0 * alpha * beta * qs
                - 2.0 * dim * beta * beta), ids.to(torch.int32)
    _, cand = topk_smallest_lowest_index(rank, s)
    cand_vecs = x_f32[cand]
    diff = cand_vecs - qj[:, None, :]
    exact = torch.sum(diff * diff, dim=-1)
    vals, pos = topk_smallest_lowest_index(exact, k)
    return vals, torch.gather(cand, 1, pos).to(torch.int32)


def topk_l2(q: np.ndarray, corpus: SQ8Corpus, k: int,
            x_f32: Optional[torch.Tensor] = None,
            shortlist_mult: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized exact-scan top-k: int8 product scores + (optional) exact
    f32 re-rank of a k*shortlist_mult shortlist (the quantized HNSW
    scoring path of the reference, generalized to full scans). Returns
    (squared distances ``[B, k]`` f32, ids ``[B, k]`` int32) on the
    corpus's device."""
    dev = corpus.codes.device
    qj = backend.to_device(np.asarray(q, np.float32), device=dev)
    q_codes, _ = encode_query(q, corpus.meta)
    m = corpus.meta
    s = min(k * shortlist_mult, corpus.codes.shape[0])
    return _topk_l2_device(
        qj, q_codes.to(dev), corpus.codes, corpus.rank_corr, x_f32,
        k, s, m.alpha, m.offset, m.dim, x_f32 is not None)
