"""Dense impact BM25 scores of a query batch over one block.

The reference's impact program (``databend_tpu/index/inverted/device.py``,
``_impact_topk_program`` / ``_impact_fused_topk_program``) builds the
``[tile, L, b, m]`` equality tensor of doc slots against query terms and
reduces it twice; XLA fuses that. ``impact_bm25_scores`` computes the same
``[b, n_pad]`` score matrix without it.

For doc ``d`` and query ``q``::

    score = sum over terms j = 0..m-1, in that order, in f32, of
            idf[q, j] * sat[d, s]   where term_ids[d, s] == qterms[q, j]
    out[q, d] = score                       if matched groups >= need[q]
                w_s * score + w_d * dist[q, d]   (when ``dist`` is given)
                -inf                        otherwise

The query batch travels as ``qpack [b, m, 4]`` int32, one 16-byte entry
``{term id, idf (f32 bits), group id, 0}`` per query term
(``pack_query_terms``): the kernel reads an entry with one load. The terms of
one group are adjacent along ``j`` (``ImpactBM25._pack_queries`` lists them
group by group), so the number of matched groups is the number of runs of
equal group ids that hold at least one matching term. A term id occurs in at
most one slot of a doc (the doc-major layout writes each posting once); pad
docs and pad slots hold -2, pad terms -1 (group -1) and follow a query's real
terms, so padding never matches; ``sat`` holds no NaN.

On a CUDA tensor ``impact_bm25_scores`` launches the hand-written kernel
``csrc/impact_bm25_scores.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version ``_impact_bm25_scores_plain``: the reference's composition,
one term column at a time and tiled over docs so that no intermediate passes
``PLAIN_BYTES``. Both add the terms in index order without fused
multiply-adds, so docs with equal terms and saturations get bit-equal scores
(the tie rule of the top-k after it depends on that).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _cuda

PLAIN_BYTES = 1 << 28     # the plain version's largest intermediate
MAX_SLOTS = 512           # the kernel keeps 32 docs x L slots in shared memory
NEG_INF = float("-inf")


def pack_query_terms(qterms, idf, qgroup):
    """``qterms``, ``qgroup`` ``[b, m]`` int32 and ``idf [b, m]`` f32 (numpy
    arrays or tensors) -> ``qpack [b, m, 4]`` int32 of the same kind."""
    if isinstance(qterms, torch.Tensor):
        return torch.stack((qterms, idf.view(torch.int32), qgroup,
                            torch.zeros_like(qterms)), dim=-1)
    return np.stack((qterms, idf.view(np.int32), qgroup,
                     np.zeros_like(qterms)), axis=-1)


def _check_inputs(term_ids, sat, qpack, need, dist):
    if term_ids.ndim != 2 or sat.shape != term_ids.shape:
        raise ValueError("impact_bm25_scores: want term_ids and sat [n_pad, L]"
                         f", got {tuple(term_ids.shape)}, {tuple(sat.shape)}")
    if qpack.ndim != 3 or qpack.shape[2] != 4:
        raise ValueError("impact_bm25_scores: want qpack [b, m, 4], got "
                         f"{tuple(qpack.shape)}")
    b = qpack.shape[0]
    n_pad = term_ids.shape[0]
    if need.shape != (b,):
        raise ValueError(f"impact_bm25_scores: want need [{b}], got "
                         f"{tuple(need.shape)}")
    if dist is not None and dist.shape != (b, n_pad):
        raise ValueError(f"impact_bm25_scores: want dist [{b}, {n_pad}], got "
                         f"{tuple(dist.shape)}")
    ints, floats = (term_ids, qpack), (sat, need)
    if dist is not None:
        floats += (dist,)
    if any(t.dtype != torch.int32 for t in ints) \
            or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("impact_bm25_scores: want int32 term_ids and qpack "
                        "and float32 sat, need and dist")
    if any(t.device != term_ids.device for t in ints + floats):
        raise ValueError("impact_bm25_scores: inputs on different devices")


def _impact_bm25_scores_plain(term_ids: torch.Tensor, sat: torch.Tensor,
                              qpack: torch.Tensor, need: torch.Tensor,
                              dist: Optional[torch.Tensor] = None,
                              w_s: float = 1.0,
                              w_d: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (see the module doc): per doc tile and term
    column ``j`` one ``[tile, L, b]`` compare-select, summed over the slots
    (at most one is non-zero, so that sum is exact)."""
    n_pad, slots = term_ids.shape
    b, m = qpack.shape[:2]
    dev = term_ids.device
    qterms, qgroup = qpack[..., 0], qpack[..., 2]
    idf = qpack[..., 1].view(torch.float32)
    tile = max(1, min(n_pad, PLAIN_BYTES // (4 * slots * b)))
    new_run = torch.ones((b, m), dtype=torch.bool, device=dev)
    new_run[:, 1:] = qgroup[:, 1:] != qgroup[:, :-1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((b, n_pad), dtype=torch.float32, device=dev)
    for s in range(0, n_pad, tile):
        ids = term_ids[s:s + tile, :, None]                   # [t, L, 1]
        st = sat[s:s + tile, :, None]
        t = ids.shape[0]
        score = torch.zeros((t, b), dtype=torch.float32, device=dev)
        groups = torch.zeros((t, b), dtype=torch.int32, device=dev)
        run_hit = torch.zeros((t, b), dtype=torch.bool, device=dev)
        for j in range(m):
            eq = ids == qterms[:, j]                          # [t, L, b]
            per_term = torch.where(eq, st, zero).sum(1)       # [t, b]
            score = score + per_term * idf[:, j]
            # a new group starts at j: close the run before it
            groups = groups + (run_hit & new_run[:, j])
            run_hit = (run_hit & ~new_run[:, j]) | eq.any(1)
        groups = groups + run_hit
        ok = groups.to(torch.float32) >= need
        if dist is not None:
            score = w_s * score + w_d * dist[:, s:s + tile].T
        out[:, s:s + tile] = torch.where(ok, score, NEG_INF).T
    return out


def impact_bm25_scores(term_ids: torch.Tensor, sat: torch.Tensor,
                       qpack: torch.Tensor, need: torch.Tensor,
                       dist: Optional[torch.Tensor] = None,
                       w_s: float = 1.0, w_d: float = 0.0) -> torch.Tensor:
    """``[b, n_pad]`` f32 scores (see the module doc).

    term_ids ``[n_pad, L]`` int32 and sat ``[n_pad, L]`` f32: the block's
    doc-major layout; qpack ``[b, m, 4]`` int32 (``pack_query_terms``) and
    need ``[b]`` f32: the packed query batch; dist ``[b, n_pad]`` f32 with the
    weights ``w_s``, ``w_d`` for the fused text+vector ranking."""
    _check_inputs(term_ids, sat, qpack, need, dist)
    if term_ids.device.type == "cpu":
        return _impact_bm25_scores_plain(term_ids, sat, qpack, need, dist,
                                         w_s, w_d)
    if term_ids.device.type != "cuda":
        raise ValueError(f"impact_bm25_scores: no kernel for {term_ids.device}")
    n_pad, slots = term_ids.shape
    b, m = qpack.shape[:2]
    if slots % 8 or not 8 <= slots <= MAX_SLOTS or b < 1 or m < 1 or n_pad < 1:
        raise ValueError(f"impact_bm25_scores: the CUDA kernel needs L % 8 == "
                         f"0, 8 <= L <= {MAX_SLOTS}, b, m, n_pad >= 1 "
                         f"(L={slots}, b={b}, m={m}, n_pad={n_pad})")
    operands = {"term_ids": term_ids, "sat": sat, "qpack": qpack,
                "need": need}
    if dist is not None:
        operands["dist"] = dist
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"impact_bm25_scores: {name} must be contiguous")
    for name in ("term_ids", "sat", "qpack"):        # read as 16-byte vectors
        if operands[name].data_ptr() % 16:
            raise ValueError(f"impact_bm25_scores: {name} must start at a "
                             "multiple of 16 bytes")
    lib = _launcher()
    out = torch.empty((b, n_pad), dtype=torch.float32, device=term_ids.device)
    with torch.cuda.device(term_ids.device):
        stream = torch.cuda.current_stream(term_ids.device).cuda_stream
        err = lib.impact_bm25_scores_launch(
            term_ids.data_ptr(), sat.data_ptr(), qpack.data_ptr(),
            need.data_ptr(), dist.data_ptr() if dist is not None else None,
            float(w_s), float(w_d), out.data_ptr(), n_pad, slots, b, m, stream)
    if err:
        msg = lib.impact_bm25_scores_error_string(err).decode()
        raise RuntimeError(f"impact_bm25_scores launch failed: {msg} ({err})")
    impact_bm25_scores.launches += 1
    return out


impact_bm25_scores.launches = 0

# the C interface of csrc/impact_bm25_scores.cu: term_ids, sat, qpack, need,
# dist (or NULL); w_s, w_d; out; n_pad, L, b, m; stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _cuda.load("impact_bm25_scores")
    lib.impact_bm25_scores_launch.argtypes = _LAUNCH_ARGTYPES
    lib.impact_bm25_scores_launch.restype = ctypes.c_int
    lib.impact_bm25_scores_error_string.argtypes = [ctypes.c_int]
    lib.impact_bm25_scores_error_string.restype = ctypes.c_char_p
    return lib
