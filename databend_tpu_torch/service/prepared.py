"""Prepared statements and batched KNN serving: the reference
``service/prepared.py`` with the serving programs on torch.

Replaced here: the whole-batch scan programs (``_scan_topk_program``,
``_scan_topk_filtered_program``, a loop over query chunks of 256 in place of
the reference's ``lax.scan``) and the ``_KnnServer`` device seams
(``_setup_filters``, ``_topk``, ``_topk_filtered``, plus the flash state,
built at a snapshot's first approximate call and shared through
``CacheManager`` by every statement over that snapshot and column).

Approximate mode (``exact=False``) on an unfiltered l2 or cosine statement
runs ``flash_topk``: the hand-written group-min scan over a bf16 copy of the
corpus, then an exact f32 re-rank of the shortlisted groups. l1 has no
matmul form and takes the plain scan. A filtered statement cannot hand its
per-query masks to the kernel, so it selects with the plain ``torch.topk``
in both modes, and its approximate answer is exact.
"""

import numpy as np
import torch

from .._reference import exec_reference
from .. import backend
from ..storage.fuse.table import _exact_topk_program, _rescore_l2
from ..utils.cache import CacheManager

exec_reference(globals(), "service/prepared.py")

# rows of the [chunk, N] score block: ~1 GB of f32 scores at N = 1M
_QUERY_CHUNK = 256
# flash_topk defaults of the reference (ops/flash_topk.py)
FLASH_TILE = 16384
FLASH_LANES = 128


def _cmp(op, c, v):
    if op in ("=", "=="):
        return c == v
    if op in ("!=", "<>"):
        return c != v
    if op == "<":
        return c < v
    if op == "<=":
        return c <= v
    if op == ">":
        return c > v
    return c >= v


def _scan_topk_program(Q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
                       n_valid: int):
    """Whole-batch exact top-k: ``_exact_topk_program`` per query chunk (one
    ``[chunk, N]`` score block each), the l2 corpus norms computed once.
    Returns device (vals ``[B, k]``, ids int32)."""
    norms = torch.sum(x * x, -1) if metric == "l2" else None
    parts = [_exact_topk_program(qb, x, k, metric, n_valid, x_sq_norms=norms)
             for qb in torch.split(Q, _QUERY_CHUNK)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def _scan_topk_filtered_program(Q: torch.Tensor, x: torch.Tensor, k: int,
                                metric: str, n_valid: int, smask, fcols,
                                fvals, f_ops):
    """Filtered whole-batch top-k: a static row mask plus per-query
    ``col op ?`` comparisons against device-resident columns. Excluded rows
    score +inf; rows that survive with +inf are trimmed by the caller (a
    query may match fewer than k rows)."""
    from ..ops.distance import pairwise_distance
    norms = torch.sum(x * x, -1) if metric == "l2" else None
    base = (torch.arange(x.shape[0], device=x.device) < n_valid) & smask
    vals, ids = [], []
    for start in range(0, Q.shape[0], _QUERY_CHUNK):
        qb = Q[start:start + _QUERY_CHUNK]
        d = pairwise_distance(qb, x, metric, x_sq_norms=norms,
                              x_normalized=(metric == "cosine"))
        m = base[None, :]
        for op, col, fv in zip(f_ops, fcols, fvals):
            m = m & _cmp(op, col[None, :],
                         fv[start:start + _QUERY_CHUNK, None])
        v, i = torch.topk(d.masked_fill_(~m, float("inf")), k, dim=1,
                          largest=False)
        vals.append(v)
        ids.append(i)
    vals, ids = torch.cat(vals), torch.cat(ids)
    if metric == "l2":
        # +inf marks "fewer than k matches": it survives the re-score
        vals = torch.where(torch.isinf(vals), vals, _rescore_l2(Q, x, ids))
    return vals, ids.to(torch.int32)


def _setup_filters(self, table, metas) -> bool:
    """Per-snapshot device state: the cache key of the snapshot's corpus
    (that of ``stacked_device_vectors``, for the flash state), then the
    WHERE state: one host-evaluated static mask + per-param-filter resident
    columns. Returns False (generic fallback) when the predicate or a column
    type is outside the servable grammar."""
    sh = self.shape
    self._corpus_key = (tuple(table.abs_path(m.location) for m in metas),
                        sh.column.lower(),
                        _DISTANCE_FNS[sh.metric_fn] == "cosine")  # noqa: F821
    self._static_mask, self._fcols = None, []
    self._fdicts, self._fkinds = [], []
    if sh.where_static is None and not sh.where_params:
        return True
    from .filter_eval import Unsupported, eval_mask, referenced_columns
    need = list(dict.fromkeys(
        referenced_columns(sh.where_static)
        + [pf.column.lower() for pf in (sh.where_params or [])]))
    cols = []
    for name in need:
        try:
            cols.append(table.schema.field(name).name)
        except Exception:
            return False
    fblock = DataBlock.concat([table.read_block(m, cols) for m in metas])  # noqa: F821
    if sh.where_static is not None:
        try:
            mask = eval_mask(fblock, sh.where_static)
        except Unsupported:
            return False
    else:
        mask = np.ones(len(fblock), bool)
    for pf in sh.where_params or []:
        col = fblock.column(table.schema.field(pf.column).name)
        if col.validity is not None:
            # NULL never satisfies any comparison
            mask = mask & col.validity
        data = col.data
        if isinstance(data, np.ndarray) and data.ndim == 1 \
                and np.issubdtype(data.dtype, np.integer):
            if len(data) and (data.min() < -2**31 or data.max() >= 2**31):
                return False   # beyond device int32 — generic path
            self._fcols.append(backend.to_device(data.astype(np.int32)))
            self._fdicts.append(None)
            self._fkinds.append("int")
        elif isinstance(data, np.ndarray) and data.ndim == 1 \
                and np.issubdtype(data.dtype, np.floating):
            self._fcols.append(backend.to_device(data.astype(np.float32)))
            self._fdicts.append(None)
            self._fkinds.append("float")
        elif hasattr(data, "as_object_array"):
            if pf.op not in ("=", "==", "!=", "<>"):
                return False   # ordering on dictionary codes is wrong
            vals = data.as_object_array()
            uniq, codes = np.unique(vals, return_inverse=True)
            self._fcols.append(backend.to_device(codes.astype(np.int32)))
            self._fdicts.append({v: i for i, v in enumerate(uniq)})
            self._fkinds.append("str")
        else:
            return False
    self._static_mask = backend.to_device(np.asarray(mask, bool))
    return True


def _flash_state(self):
    """(bf16 corpus padded to FLASH_TILE rows and D % 16 == 0, norms) for
    approximate serving. Built at the first approximate call on a snapshot
    and cached beside the stacked corpus, so the statements over one
    snapshot and column share one copy. l2 keeps exact f32 norms; cosine
    uses the normalized corpus with zero norms (metric ip). Pad rows carry
    +inf norms."""
    x = self._x
    normalized = self._corpus_key[2]

    def load():
        from ..ops.flash_topk import pad_for_flash
        xb = x.to(torch.bfloat16)
        if x.shape[1] % 16:
            xb = torch.nn.functional.pad(xb, (0, 16 - x.shape[1] % 16))
        norms = x.new_zeros(x.shape[0]) if normalized \
            else torch.sum(x * x, -1)
        xb, norms, _ = pad_for_flash(xb, norms, FLASH_TILE)
        return xb.contiguous(), norms.contiguous()

    cm = CacheManager.instance().vector_columns
    return cm.get_or_load(("flash",) + self._corpus_key, load)


def _flash_select(self, Q: torch.Tensor, metric: str, k: int):
    """Approximate top-k through flash_topk, per query chunk: l2 returns the
    square root of the exact squared distance, cosine ``1 - dot``."""
    from ..ops.distance import normalize
    from ..ops.flash_topk import flash_topk
    xb, norms = self._flash_state()
    vals, ids = [], []
    for qb in torch.split(Q, _QUERY_CHUNK):
        if metric == "cosine":
            qb = normalize(qb)
        v, i = flash_topk(qb, xb, norms, self._x, k,
                          "l2" if metric == "l2" else "ip",
                          tile=FLASH_TILE, buckets=FLASH_LANES,
                          n_valid=self._n)
        vals.append(torch.sqrt(torch.clamp_min(v, 0.0)) if metric == "l2"
                    else 1.0 + v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids).to(torch.int32)


def _topk(self, Q: np.ndarray, exact: bool = True, fvals=None):
    """Device top-k for the whole batch + ONE bulk projection gather.
    Returns (vals [B,k], ids [B,k], taken_all [B*k rows], k)."""
    metric = _DISTANCE_FNS[self.shape.metric_fn]  # noqa: F821
    k = min(self.shape.k, self._n)
    if self._static_mask is not None:
        return self._topk_filtered(Q, exact, fvals or [], metric, k)
    Qd = backend.to_device(Q)
    if not exact and self._n and metric in ("l2", "cosine"):
        vals, ids = self._flash_select(Qd, metric, k)
    else:
        vals, ids = _scan_topk_program(Qd, self._x, k, metric, self._n)
    vals, ids = backend.to_numpy([vals, ids])
    taken_all = (self._proj.take(ids.reshape(-1))
                 if self._proj is not None else None)
    return vals, ids, taken_all, k


def _topk_filtered(self, Q: np.ndarray, exact: bool, fvals, metric: str,
                   k: int):
    """Filtered variant: the static mask + per-query operand comparisons.
    Exact in both modes (see the module doc)."""
    f_ops = tuple(pf.op for pf in self.shape.where_params or [])
    vals, ids = _scan_topk_filtered_program(
        backend.to_device(Q), self._x, k, metric, self._n, self._static_mask,
        self._fcols, [backend.to_device(v) for v in fvals], f_ops)
    vals, ids = backend.to_numpy([vals, ids])
    taken_all = (self._proj.take(ids.reshape(-1))
                 if self._proj is not None else None)
    return vals, ids, taken_all, k


_KnnServer._flash_state = _flash_state  # noqa: F821
_KnnServer._flash_select = _flash_select  # noqa: F821
_KnnServer._setup_filters = _setup_filters  # noqa: F821
_KnnServer._topk = _topk  # noqa: F821
_KnnServer._topk_filtered = _topk_filtered  # noqa: F821
