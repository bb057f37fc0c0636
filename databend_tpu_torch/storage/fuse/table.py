"""FuseTable: the reference ``storage/fuse/table.py`` with its vector device
seams on torch.

The snapshot, segment and block code is the reference's own (the Fuse files
on disk are shared by both packages). Replaced here: the device-resident
vector columns (``device_vectors``, ``stacked_device_vectors``), the exact
scans (``brute_force_block_scores``, ``batch_exact_topk``,
``batch_generate_scores``) and the programs under them
(``_exact_topk_program``, ``_stacked_scores_program``). PyTorch runs eagerly,
so the reference's jit factory ``_jit_vector_programs`` has no counterpart.
Each call brings its results to the host with one copy.
"""

from typing import List

import numpy as np
import torch

from ..._reference import exec_reference
from ... import backend

exec_reference(globals(), "storage/fuse/table.py")

# jit program factory and its caches: nothing to compile in eager torch
del _jit_vector_programs, _EXACT_TOPK, _STACKED_SCORES  # noqa: F821


def device_vectors(self, meta, col_name: str, normalized: bool):
    """Block's vector column as a device-resident tensor (cached).

    Rows pad with zeros to the SPAN_QUANTUM grid, as in the reference;
    consumers mask padding by index (meta.row_count is the valid count)."""
    from ...ops.distance import normalize
    cm = CacheManager.instance().vector_columns  # noqa: F821
    key = (self.abs_path(meta.location), col_name.lower(), normalized)

    def load():
        col = self.read_block(meta, [col_name]).column(col_name)
        arr = np.asarray(col.numpy(), np.float32)
        rem = (-arr.shape[0]) % SPAN_QUANTUM  # noqa: F821
        if rem and arr.shape[0] > SPAN_QUANTUM // 4:  # noqa: F821
            arr = np.concatenate(
                [arr, np.zeros((rem, arr.shape[1]), np.float32)], axis=0)
        dev = backend.to_device(arr)
        return normalize(dev) if normalized else dev

    return cm.get_or_load(key, load)


def brute_force_block_scores(self, meta, info, q: np.ndarray, limit: int):
    """Exact scan for a block without an index (reference
    HNSWIndex::generate_scores, hnsw.rs:120) -> numpy (vals, ids)."""
    metric = info.func_name.replace("_distance", "")
    x_dev = self.device_vectors(meta, info.column,
                                normalized=(metric == "cosine"))
    k = min(limit, meta.row_count)
    vals, ids = _exact_topk_program(np.asarray(q, np.float32), x_dev, k,
                                    metric, n_valid=meta.row_count)
    return tuple(backend.to_numpy([vals, ids]))


def stacked_device_vectors(self, metas: List, col_name: str,
                           normalized: bool):
    """All listed blocks' vector columns as ONE device-resident ``[total, d]``
    tensor (+ row offsets), cached per block set. Used only for stable sets
    (the whole table)."""
    cm = CacheManager.instance().vector_columns  # noqa: F821
    locs = tuple(self.abs_path(m.location) for m in metas)
    key = ("stacked", locs, col_name.lower(), normalized)

    def load():
        from ...ops.distance import normalize
        # host assembly (NOT device_vectors: those pad to the quantum
        # grid, which would interleave dead rows mid-corpus)
        arrs = [np.asarray(self.read_block(m, [col_name])
                           .column(col_name).numpy(), np.float32)
                for m in metas]
        offsets = np.zeros(len(arrs) + 1, np.int64)
        for i, a in enumerate(arrs):
            offsets[i + 1] = offsets[i] + a.shape[0]
        dev = backend.to_device(np.concatenate(arrs, axis=0)
                                if len(arrs) > 1 else arrs[0])
        return (normalize(dev) if normalized else dev), offsets

    return cm.get_or_load(key, load)


def batch_exact_topk(self, metas: List, info, q: np.ndarray, limit: int,
                     host_max_rows: int = 0):
    """One stacked exact scan over many blocks -> global top-k as
    [(block_idx, row_in_block, score)]. Corpora <= ``host_max_rows`` are
    scored on the host (reference code path)."""
    metric = info.func_name.replace("_distance", "")
    total = sum(m.row_count for m in metas)
    if total <= host_max_rows:
        return _reference_batch_exact_topk(self, metas, info, q, limit,
                                           host_max_rows)
    qn = np.asarray(q, np.float32)
    if self._is_full_block_set(metas, total):
        # stable set: one scan over the cached stacked corpus
        x_dev, offsets = self.stacked_device_vectors(
            metas, info.column, normalized=(metric == "cosine"))
        k = min(limit, int(x_dev.shape[0]))
        vals, ids = backend.to_numpy(
            list(_exact_topk_program(qn, x_dev, k, metric)))
        out = []
        for gid, s in zip(ids[0].tolist(), vals[0].tolist()):
            bi = int(np.searchsorted(offsets, gid, side="right") - 1)
            out.append((bi, gid - int(offsets[bi]), float(s)))
        return out
    # pruned subset: one scan per block (all enqueued before one fetch)
    pend = []
    for m in metas:
        x_dev = self.device_vectors(m, info.column,
                                    normalized=(metric == "cosine"))
        k = min(limit, m.row_count)
        pend.extend(_exact_topk_program(qn, x_dev, k, metric,
                                        n_valid=m.row_count))
    fetched = backend.to_numpy(pend)
    out = []
    for bi in range(len(metas)):
        vals, ids = fetched[2 * bi], fetched[2 * bi + 1]
        for r, s in zip(ids[0].tolist(), vals[0].tolist()):
            out.append((bi, int(r), float(s)))
    out.sort(key=lambda t: t[2])
    return out[:limit]


def batch_generate_scores(self, metas: List, info,
                          host_max_rows: int = 0) -> List[np.ndarray]:
    """Exact scores for EVERY row of every listed block (the filtered-KNN /
    DESC / score-only path); one f32 array per block. Small corpora run on
    the host (reference code path)."""
    metric = info.func_name.replace("_distance", "")
    total = sum(m.row_count for m in metas)
    if total <= host_max_rows:
        return _reference_batch_generate_scores(self, metas, info,
                                                host_max_rows)
    q = np.asarray(info.query_values, np.float32)[None, :]
    if self._is_full_block_set(metas, total):
        x_dev, offsets = self.stacked_device_vectors(
            metas, info.column, normalized=(metric == "cosine"))
        scores = backend.to_numpy(_stacked_scores_program(q, x_dev, metric))[0]
        return [scores[offsets[i]:offsets[i + 1]] for i in range(len(metas))]
    # pruned subset: per-block scans, one fetch; drop the quantum padding
    pend = []
    for m in metas:
        x_dev = self.device_vectors(m, info.column,
                                    normalized=(metric == "cosine"))
        pend.append(_stacked_scores_program(q, x_dev, metric)[0, :m.row_count])
    return backend.to_numpy(pend)


def _exact_topk_program(q, x: torch.Tensor, k: int, metric: str,
                        n_valid=None, x_sq_norms=None):
    """Exact top-k of ``q [B, d]`` against ``x``: scores, index mask of the
    pad rows past ``n_valid``, k-select and, for l2, a diff-based re-score of
    the winners (the norm expansion cancels catastrophically for tiny
    distances). ``x_sq_norms`` (l2): ``x``'s row norms, when the caller
    scans ``x`` more than once. Returns device tensors (vals ``[B, k]`` f32,
    ids int32)."""
    from ...ops.distance import pairwise_distance
    qd = q if isinstance(q, torch.Tensor) else backend.to_device(
        np.asarray(q, np.float32))
    d = pairwise_distance(qd, x, metric, x_sq_norms=x_sq_norms,
                          x_normalized=(metric == "cosine"))
    if n_valid is not None and n_valid < x.shape[0]:
        # rows past n_valid are block padding: masked by INDEX, since no
        # pad value is safe for every metric
        d[:, n_valid:] = float("inf")
    vals, ids = torch.topk(d, k, dim=1, largest=False)
    if metric == "l2":
        vals = _rescore_l2(qd, x, ids)
    return vals, ids.to(torch.int32)


def _rescore_l2(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor):
    """Exact diff-based l2 of the winners ``ids [B, k]``: the norm expansion
    cancels catastrophically for tiny distances."""
    diff = x[ids] - q[:, None, :]                             # [B, k, d]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, -1), 0.0))


def _stacked_scores_program(q, x: torch.Tensor, metric: str) -> torch.Tensor:
    """``[B, N]`` exact scores of ``q`` against every row of ``x``."""
    from ...ops.distance import pairwise_distance
    qd = q if isinstance(q, torch.Tensor) else backend.to_device(
        np.asarray(q, np.float32))
    return pairwise_distance(qd, x, metric, x_normalized=(metric == "cosine"))


_reference_batch_exact_topk = FuseTable.batch_exact_topk  # noqa: F821
_reference_batch_generate_scores = FuseTable.batch_generate_scores  # noqa: F821
FuseTable.device_vectors = device_vectors  # noqa: F821
FuseTable.brute_force_block_scores = brute_force_block_scores  # noqa: F821
FuseTable.stacked_device_vectors = stacked_device_vectors  # noqa: F821
FuseTable.batch_exact_topk = batch_exact_topk  # noqa: F821
FuseTable.batch_generate_scores = batch_generate_scores  # noqa: F821
