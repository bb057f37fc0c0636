"""The pruning pipeline: segment -> block -> bloom -> topn -> vector.

Mirrors the reference's pruning order (reference:
src/query/storages/fuse/src/pruning/fuse_pruner.rs:344-509: internal-column
prune -> segment range prune -> block prune (limit/range/bloom/inverted) ->
TopN prune -> vector prune), re-expressed for a TPU engine: per-block HNSW
beam searches are *batched device programs* over HBM-cached vector columns
and the global top-k merge is one `top_k` over the stacked per-block
results (replacing FixedLengthPriorityQueue, vector_index_pruner.rs:241-303).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ....catalog.pushdown import PushDownInfo
from ....expression.expr import (BoundColumn, CastExpr, Constant, Func,
                                 ScalarExpr)
from ....utils.cache import CacheManager
from ..snapshot import BlockMeta, SegmentInfo
from ..statistics import VectorStats, score_domain
from .range_pruner import range_should_keep


@dataclass
class PrunedBlock:
    meta: BlockMeta
    # HNSW top-k path: rows that made the global top-k -> (row_idx, score)
    vector_scores: Optional[List[Tuple[int, float]]] = None
    # inverted index: matched rows (and BM25 scores when requested)
    matched_rows: Optional[List[int]] = None
    matched_scores: Optional[List[float]] = None
    # filtered-KNN path: full per-row score vector, computed for all
    # surviving blocks in ONE stacked device program (set by the executor)
    precomputed_scores: Optional[np.ndarray] = None


@dataclass
class PruningStats:
    segments_before: int = 0
    segments_after: int = 0
    blocks_before: int = 0
    blocks_range_after: int = 0
    blocks_bloom_after: int = 0
    blocks_inverted_after: int = 0
    blocks_topn_after: int = 0
    blocks_vector_stats_after: int = 0
    blocks_after: int = 0

    def as_dict(self):
        return dict(self.__dict__)


class FusePruner:
    def __init__(self, table, pushdown: Optional[PushDownInfo]):
        self.table = table  # FuseTable
        self.pushdown = pushdown or PushDownInfo()
        self.stats = PruningStats()

    # ------------------------------------------------------------------ main
    def prune(self, segments: List[SegmentInfo]) -> List[PrunedBlock]:
        pd = self.pushdown
        self.stats.segments_before = len(segments)
        kept_segments = [
            s for s in segments
            if pd.filters is None or range_should_keep(pd.filters, s.summary)]
        self.stats.segments_after = len(kept_segments)

        blocks: List[BlockMeta] = [b for s in kept_segments for b in s.blocks]
        self.stats.blocks_before = len(blocks)

        # range prune
        if pd.filters is not None:
            blocks = [b for b in blocks if range_should_keep(pd.filters, b.col_stats)]
        self.stats.blocks_range_after = len(blocks)

        # bloom prune (point predicates)
        if pd.filters is not None:
            blocks = self._bloom_prune(blocks)
            blocks = self._ngram_prune(blocks)
            blocks = self._spatial_prune(blocks)
        self.stats.blocks_bloom_after = len(blocks)

        # inverted index prune (match()/query())
        pruned: List[PrunedBlock] = [PrunedBlock(b) for b in blocks]
        if pd.inverted_index is not None:
            pruned = self._inverted_prune(pruned)
        self.stats.blocks_inverted_after = len(pruned)

        # limit prune: no filter/order -> first blocks covering the limit
        if (pd.limit is not None and pd.filters is None and not pd.order_by
                and pd.vector_index is None and pd.inverted_index is None):
            pruned = self._limit_prune(pruned, pd.limit)

        # TopN prune for plain ORDER BY col LIMIT n (setting enable_top_n)
        if (pd.limit is not None and len(pd.order_by) == 1
                and pd.enable_topn
                and pd.vector_index is None and pd.filters is None
                and pd.inverted_index is None):
            pruned = self._topn_prune(pruned, pd.order_by[0], pd.limit)
        self.stats.blocks_topn_after = len(pruned)

        # vector prune (HNSW top-k)
        if pd.vector_index is not None and pd.vector_index.topk_asc and pd.limit:
            pruned = self._vector_prune(pruned)
        self.stats.blocks_after = len(pruned)
        return pruned

    # ---------------------------------------------------------------- pieces
    def _limit_prune(self, blocks: List[PrunedBlock], limit: int) -> List[PrunedBlock]:
        out, acc = [], 0
        for b in blocks:
            out.append(b)
            acc += b.meta.row_count
            if acc >= limit:
                break
        return out

    def _topn_prune(self, blocks: List[PrunedBlock], order, limit: int) -> List[PrunedBlock]:
        """reference: topn_pruner.rs:34-100 — sort blocks by the sort
        column's min (asc) / max (desc); keep the cheapest blocks covering
        `limit` rows, then every block overlapping the worst kept bound."""
        col = order.column
        stats = [(b, b.meta.col_stats.get(col)) for b in blocks]
        if any(s is None or s.min is None for _, s in stats):
            return blocks
        if order.asc:
            ranked = sorted(stats, key=lambda t: (t[1].min, t[1].max))
        else:
            ranked = sorted(stats, key=lambda t: (-_num(t[1].max), -_num(t[1].min)))
        bound = None
        kept, acc = [], 0
        for b, s in ranked:
            kept.append((b, s))
            acc += b.meta.row_count
            if acc >= limit:
                bound = s.max if order.asc else s.min
                break
        if bound is None:
            return blocks
        out = [b for b, s in kept]
        chosen = {id(b) for b in out}
        for b, s in ranked:
            if id(b) in chosen:
                continue
            # overlapping blocks may still hold rows within the bound
            if (order.asc and s.min <= bound) or (not order.asc and s.max >= bound):
                out.append(b)
        return out

    def _bloom_prune(self, blocks: List[BlockMeta]) -> List[BlockMeta]:
        from ....index.bloom import BloomFilter, hash_literal
        points = _extract_point_predicates(self.pushdown.filters)
        if not points:
            return blocks
        cache = CacheManager.instance().bloom_filters

        def block_keeps(b) -> bool:
            if b.bloom_index is None:
                return True
            for col_name, value, dtype in points:
                loc = b.bloom_index.get("columns", {}).get(col_name.lower())
                if loc is None:
                    continue
                h = hash_literal(value, dtype)
                if h is None:
                    continue
                flt = cache.get_or_load(
                    self.table.abs_path(b.bloom_index["location"]) + "#" + col_name.lower(),
                    lambda loc=loc, b=b: self.table.load_bloom(b, col_name.lower()))
                if flt is not None and not flt.contains_hash(h):
                    return False
            return True

        if len(blocks) > 16:
            # filter loads are file IO: fan out on the pruning runtime
            # (reference: the pruning tasks run on their own runtime,
            # fuse_pruner.rs:386 — separated from block IO in
            # utils/runtimes.py)
            from ....utils.runtimes import pool
            keeps = list(pool("pruning").map(block_keeps, blocks))
            return [b for b, k in zip(blocks, keeps) if k]
        return [b for b in blocks if block_keeps(b)]

    def _spatial_prune(self, blocks: List[BlockMeta]) -> List[BlockMeta]:
        """Drop blocks whose geometry bbox misses an st_within_bbox query
        box (reference spatial_index_pruner.rs)."""
        boxes = _extract_bbox_predicates(self.pushdown.filters)
        if not boxes:
            return blocks
        out = []
        for b in blocks:
            keep = True
            for col_name, (x1, y1, x2, y2) in boxes:
                st = b.col_stats.get(col_name)
                if st is None or not isinstance(st.min, list) \
                        or not isinstance(st.max, list):
                    continue
                (bx1, by1), (bx2, by2) = st.min, st.max
                if bx1 > x2 or bx2 < x1 or by1 > y2 or by2 < y1:
                    keep = False
                    break
            if keep:
                out.append(b)
        return out

    def _ngram_prune(self, blocks: List[BlockMeta]) -> List[BlockMeta]:
        """Skip blocks whose ngram filter is missing any gram of a LIKE
        pattern's literal segments (reference NgramArgs,
        bloom_index.rs:649)."""
        likes = _extract_like_predicates(self.pushdown.filters)
        if not likes:
            return blocks
        import numpy as np
        from ....index.bloom import BloomFilter
        from ....index.ngram import filter_may_match
        out = []
        for b in blocks:
            if b.ngram_index is None:
                out.append(b)
                continue
            keep = True
            data = None
            for col_name, pattern in likes:
                n = b.ngram_index.get("columns", {}).get(col_name.lower())
                if n is None:
                    continue
                if data is None:
                    from ...operator import OPERATOR
                    data = np.load(OPERATOR.open_read(
                        self.table.abs_path(b.ngram_index["location"])))
                flt = BloomFilter.from_bytes(data[col_name.lower()].tobytes())
                if not filter_may_match(flt, pattern, int(n)):
                    keep = False
                    break
            if keep:
                out.append(b)
        return out

    def _inverted_prune(self, blocks: List[PrunedBlock]) -> List[PrunedBlock]:
        info = self.pushdown.inverted_index
        out = []
        for pb in blocks:
            res = self.table.search_inverted(pb.meta, info)
            if res is None:
                out.append(pb)  # block has no index: keep, scan filters later
                continue
            rows, scores = res
            if len(rows) == 0:
                continue
            pb.matched_rows = rows
            pb.matched_scores = scores
            out.append(pb)
        return out

    # ------------------------------------------------------------ vector path
    def _vector_prune(self, blocks: List[PrunedBlock]) -> List[PrunedBlock]:
        """Stats prune + per-block HNSW search + global top-k merge
        (reference: vector_index_pruner.rs:178-303,544-617)."""
        info = self.pushdown.vector_index
        limit = self.pushdown.limit
        metric = info.func_name.replace("_distance", "")
        q = np.asarray(info.query_values, np.float32)[None, :]

        # (a) stats prune on centroid/radius score domains
        domains = []
        for pb in blocks:
            vs = pb.meta.vector_stats_for(info.index_name)
            dom = score_domain(vs, q[0], metric) if vs is not None else None
            domains.append(dom)
        if all(d is not None for d in domains) and blocks:
            order = sorted(range(len(blocks)), key=lambda i: domains[i][1])
            acc, threshold = 0, None
            for i in order:
                acc += blocks[i].meta.row_count
                if acc >= limit:
                    threshold = domains[i][1]
                    break
            if threshold is not None:
                keep = [i for i in range(len(blocks)) if domains[i][0] <= threshold]
                blocks = [blocks[i] for i in keep]
        self.stats.blocks_vector_stats_after = len(blocks)

        # (b) distributed exact scan over the device mesh: when no block
        # has an HNSW graph and >1 device, the candidate blocks become one
        # row-sharded corpus searched with per-shard top-k + all_gather
        # merge over ICI (reference distributed pruning,
        # read_partitions.rs:263-290 + MergeExchange)
        has_graphs = any(info.index_name in pb.meta.vector_indexes
                         and pb.meta.vector_indexes[info.index_name].get("graphs")
                         for pb in blocks)
        total_rows = sum(pb.meta.row_count for pb in blocks)
        if (self.pushdown.enable_distributed and not has_graphs and blocks
                and total_rows > self.pushdown.vector_host_scan_max_rows):
            dist = self._vector_prune_distributed(blocks, info, q, limit)
            if dist is not None:
                return dist

        # per-block search, ef = 4*limit. The exact scan beats graph
        # traversal up to 1M-row blocks (a top-10 over 1M rows: 9-18 ms
        # exact at recall 1.0, 71-529 ms through the graphs at recall
        # 0.66-0.95 for blocks of 1,048,576 to 65,536 rows; NVIDIA H100
        # 80GB HBM3, 700.00 W; chip_smoke.py --gates), so auto mode
        # prefers it.
        # Exact-scan blocks are STACKED into one device program per query
        # (one dispatch, not one per block); HNSW blocks search per-graph.
        mode = self.pushdown.vector_search_mode
        results = []  # (block_idx, row, score)
        exact_idx: List[int] = []
        for bi, pb in enumerate(blocks):
            use_exact = (mode == "exact"
                         or (mode == "auto" and pb.meta.row_count
                             <= self.pushdown.vector_exact_scan_max_rows))
            hit = None
            if not use_exact:
                hit = self.table.search_vector_index(pb.meta, info, q, limit)
            if hit is None:
                exact_idx.append(bi)
                continue
            dists, rows = hit  # [1, k] each
            for r, s in zip(rows[0].tolist(), dists[0].tolist()):
                if r >= 0:
                    results.append((bi, r, s))
        if exact_idx:
            hits = self.table.batch_exact_topk(
                [blocks[i].meta for i in exact_idx], info, q, limit,
                host_max_rows=self.pushdown.vector_host_scan_max_rows)
            results.extend((exact_idx[lb], r, s) for lb, r, s in hits)

        # (c) global merge: keep only blocks contributing to global top-k
        results.sort(key=lambda t: t[2])
        results = results[:limit]
        per_block: Dict[int, List[Tuple[int, float]]] = {}
        for bi, r, s in results:
            per_block.setdefault(bi, []).append((r, s))
        out = []
        for bi, pb in enumerate(blocks):
            if bi in per_block:
                pb.vector_scores = per_block[bi]
                out.append(pb)
        return out


    def _vector_prune_distributed(self, blocks, info, q, limit):
        """Mesh-sharded exact top-k across candidate blocks on
        ``get_default_mesh()`` (its devices as one shard axis); returns
        pruned blocks with vector_scores, or None to fall back
        single-device. The decline happens only before the first upload:
        from the upload on, an error propagates."""
        import numpy as np
        import torch
        from ....parallel import shard_rows, sharded_brute_force_topk
        from ....parallel.mesh import DP_AXIS, P, get_default_mesh, put_sharded
        mesh = get_default_mesh()
        if mesh is None:
            return None
        if mesh.shape[DP_AXIS] > 1:
            mesh = mesh.regrid(1)      # keeps each position's owner
        metric = info.func_name.replace("_distance", "")
        cols = []
        offsets = [0]
        for pb in blocks:
            b = self.table.read_block(pb.meta, [info.column])
            arr = np.asarray(b.column(info.column).data, np.float32)
            cols.append(arr)
            offsets.append(offsets[-1] + arr.shape[0])
        corpus = np.concatenate(cols, axis=0)
        if metric == "cosine":
            from ....ops.distance import normalize
            corpus = normalize(torch.from_numpy(corpus)).numpy()
            qn = normalize(torch.from_numpy(q.astype(np.float32))).numpy()
            metric_used, qq = "ip", qn
        else:
            metric_used, qq = ("l2" if metric == "l2" else metric), q
        x_dev, n_valid = shard_rows(corpus, mesh)
        q_dev = put_sharded(np.asarray(qq, np.float32), mesh,
                            P(DP_AXIS, None))
        k = min(limit, n_valid)
        dists, ids = sharded_brute_force_topk(mesh, q_dev, x_dev, k,
                                              metric_used, n_valid=n_valid)
        dists = np.asarray(dists)[0]
        ids = np.asarray(ids)[0]
        if metric == "cosine":
            dists = 1.0 + dists  # ip = -dot on normalized vectors
        results = []
        bounds = np.asarray(offsets)
        for gid, s in zip(ids.tolist(), dists.tolist()):
            if gid < 0 or gid >= n_valid:
                continue
            bi = int(np.searchsorted(bounds, gid, side="right") - 1)
            results.append((bi, gid - int(bounds[bi]), float(s)))
        per_block = {}
        for bi, r, s in results:
            per_block.setdefault(bi, []).append((r, s))
        out = []
        for bi, pb in enumerate(blocks):
            if bi in per_block:
                pb.vector_scores = per_block[bi]
                out.append(pb)
        return out


def _num(v):
    return v if isinstance(v, (int, float)) else 0


def _extract_bbox_predicates(expr: Optional[ScalarExpr]):
    """(col, (x1, y1, x2, y2)) from AND-ed st_within_bbox(col, consts)."""
    out = []
    if expr is None:
        return out

    def visit(e: ScalarExpr):
        if not isinstance(e, Func):
            return
        if e.name == "and":
            for a in e.args:
                visit(a)
            return
        if e.name == "st_within_bbox" and len(e.args) == 5:
            col = e.args[0]
            col = col.arg if isinstance(col, CastExpr) else col
            bounds = []
            for a in e.args[1:]:
                a = a.arg if isinstance(a, CastExpr) else a
                if not isinstance(a, Constant):
                    return
                bounds.append(float(a.value))
            if isinstance(col, BoundColumn):
                out.append((col.name, tuple(bounds)))

    visit(expr)
    return out


def _extract_like_predicates(expr: Optional[ScalarExpr]):
    """(col, pattern) pairs from top-level AND-ed LIKE predicates."""
    out = []
    if expr is None:
        return out

    def visit(e: ScalarExpr):
        if not isinstance(e, Func):
            return
        if e.name == "and":
            for a in e.args:
                visit(a)
            return
        if e.name == "like" and len(e.args) == 2:
            a, b = e.args
            a2 = a.arg if isinstance(a, CastExpr) else a
            b2 = b.arg if isinstance(b, CastExpr) else b
            if isinstance(a2, BoundColumn) and isinstance(b2, Constant) \
                    and isinstance(b2.value, str):
                out.append((a2.name, b2.value))

    visit(expr)
    return out


def _extract_point_predicates(expr: Optional[ScalarExpr]):
    """Collect (col, const, dtype) from top-level AND-ed equality predicates
    (what bloom filters can answer; reference bloom_index.rs)."""
    out = []
    if expr is None:
        return out

    def visit(e: ScalarExpr, top_and: bool):
        if not isinstance(e, Func):
            return
        if e.name == "and":
            for a in e.args:
                visit(a, top_and)
            return
        if e.name == "eq" and top_and:
            a, b = e.args
            a2 = a.arg if isinstance(a, CastExpr) else a
            b2 = b.arg if isinstance(b, CastExpr) else b
            if isinstance(a2, BoundColumn) and isinstance(b2, Constant):
                out.append((a2.name, b2.value, a2.dtype))
            elif isinstance(b2, BoundColumn) and isinstance(a2, Constant):
                out.append((b2.name, a2.value, b2.dtype))

    visit(expr, True)
    return out
