"""FuseTable: snapshot-storage table engine.

Re-design of the reference's fuse engine (reference:
src/query/storages/fuse/src/ — append: operations/append.rs:55 +
io/write/block_writer.rs:167; read: operations/read_partitions.rs:216;
commit: operations/common/processors/sink_commit.rs:791-808) for a
TPU-serving engine:

* blocks are parquet files; vector columns land in HBM via a process-wide
  device cache on first touch and stay there for the serving workload;
* per-block indexes (HNSW graphs, bloom filters, inverted indexes) are
  built AT WRITE TIME on the TPU (dense kNN construction, build.py) and
  stored as sidecar files — write amplification identical to the
  reference's design;
* commits swap the snapshot pointer in the meta KV with CAS; concurrent
  appends retry by re-basing on the new snapshot (append-only conflict
  resolution, like the reference's TableVersionMismatched retry).

In the port the vector columns are torch tensors on ``backend.device()``
and the exact scans (``_exact_topk_program``, ``_stacked_scores_program``)
run eagerly; each call brings its results to the host with one copy.

Spans (``utils/tracing.py``): ``fuse_append`` around an append, with
``fuse_normalize``, ``fuse_cluster_sort``, ``fuse_write_block`` (each
block's parquet encode and write), ``fuse_block_indexes`` (its stats,
bloom, vector and other indexes) and ``fuse_commit``; ``fuse_read_block``
around a block's decode on a cache miss; ``fuse_stack`` and
``fuse_upload`` around the stacked corpus's host assembly and upload.
"""

from __future__ import annotations

import io
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ... import backend
from ...catalog.catalog import Catalog, TableIndexDef, TableInfo
from ...catalog.pushdown import PushDownInfo, VectorIndexInfo
from ...errors import (StorageOther, TableVersionMismatched,
                       UnsupportedFeature, VectorError)
from ...expression import Column, DataBlock
from ...expression.schema import TableSchema
from ...types import VectorType
from ...utils.cache import CacheManager
from ...utils.tracing import span
from . import block_io
from ..operator import OPERATOR
from .snapshot import (BlockMeta, SegmentInfo, TableSnapshot, new_uuid,
                       read_json, write_json)
from .statistics import block_stats, vector_stats

DEFAULT_ROW_PER_BLOCK = 262144  # reference caps vector-cluster batches here
DEFAULT_HNSW_M = 16             # reference vector_index_writer.rs:54
DEFAULT_EF_CONSTRUCT = 100      # reference vector_index_writer.rs:55
COMMIT_RETRIES = 10
# blocks at or below this row count serve faster from the exact scan than
# from a graph (a top-10 over 1M rows: 9-18 ms exact, 71-529 ms through the
# graphs at ef = 40 for blocks of 1,048,576 to 65,536 rows; NVIDIA H100 80GB
# HBM3, 700.00 W; chip_smoke.py --gates), so graphs='auto' skips the HNSW
# build for them; equal to settings.py's vector_exact_scan_max_rows
GRAPH_BUILD_MIN_ROWS = 1 << 20


# block sizes are multiples of this so the per-block device programs
# compile once per (size, k) instead of once per arbitrary row count
SPAN_QUANTUM = 4096


def _block_spans(n_rows: int, rpb: int, cluster_runs=None):
    """Block boundaries for append: plain rpb slices, or — when cluster
    run lengths are known — EXACT cuts at cluster boundaries (clusters
    larger than rpb split at rpb). Pure blocks keep tight centroid/radius
    domains for the routing prune (vector_index_pruner.rs:544-617)."""
    if n_rows <= 0:
        return
    if not cluster_runs:
        for start in range(0, n_rows, rpb):
            yield start, min(start + rpb, n_rows)
        return
    # exact cluster alignment on disk; the DEVICE arrays pad to the
    # SPAN_QUANTUM grid at load (device_vectors) with index-masked
    # scoring, so ragged block sizes never multiply compile counts
    yield from _aligned_spans(n_rows, rpb, cluster_runs)


def _aligned_spans(n_rows: int, rpb: int, cluster_runs):
    """Exact cluster-aligned spans: whole clusters pack up to rpb;
    oversized clusters split at rpb."""
    start = 0   # current block's first row
    pos = 0     # rows consumed
    for run in cluster_runs:
        if pos > start and (pos - start) + run > rpb:
            yield start, pos
            start = pos
        if run > rpb:
            if pos > start:
                yield start, pos
            for s in range(pos, pos + run, rpb):
                yield s, min(s + rpb, pos + run)
            pos += run
            start = pos
        else:
            pos += run
    if pos > start:
        yield start, pos
    if pos < n_rows:  # safety: rows beyond the recorded runs
        for s in range(pos, n_rows, rpb):
            yield s, min(s + rpb, n_rows)


class FuseTable:
    def __init__(self, info: TableInfo, catalog: Catalog, data_root: str):
        self.info = info
        self.catalog = catalog
        self.table_dir = os.path.join(data_root, str(info.table_id))
        OPERATOR.makedirs(self.table_dir)

    # ------------------------------------------------------------------ paths
    def abs_path(self, rel: str) -> str:
        return os.path.join(self.table_dir, rel)

    @property
    def schema(self) -> TableSchema:
        return self.info.schema

    def row_per_block(self) -> int:
        return int(self.info.options.get("row_per_block", DEFAULT_ROW_PER_BLOCK))

    # ------------------------------------------------------------- snapshots
    def read_snapshot(self, snapshot_id=None) -> Optional[TableSnapshot]:
        """Resolve the head snapshot, a specific snapshot id, or a time-travel
        point ``(kind, value)`` with kind in snapshot|offset|timestamp
        (reference: operations/navigate.rs — AT (SNAPSHOT/OFFSET/TIMESTAMP))."""
        if isinstance(snapshot_id, tuple):
            return self.navigate(snapshot_id)
        if snapshot_id:
            path = self.abs_path(f"_ss/{snapshot_id}.json")
            if not OPERATOR.exists(path):
                raise StorageOther(f"unknown snapshot {snapshot_id!r}")
            return TableSnapshot.from_dict(read_json(path))
        loc, _ = self.catalog.get_snapshot_location(self.info.table_id)
        if loc is None:
            return None
        return TableSnapshot.from_dict(read_json(self.abs_path(loc)))

    def navigate(self, point) -> Optional[TableSnapshot]:
        """Walk the prev_snapshot chain to a time-travel point."""
        kind, value = point
        if kind == "snapshot":
            return self.read_snapshot(str(value))
        head = self.read_snapshot()
        if head is None:
            return None
        if kind == "timestamp":
            target = float(value)
        elif kind == "offset":
            target = time.time() + float(value)  # offset is negative seconds
        else:
            raise StorageOther(f"unknown travel point kind {kind!r}")
        snap = head
        while snap is not None and snap.timestamp > target:
            if not snap.prev_snapshot:
                raise StorageOther(
                    "no snapshot exists at or before the requested time")
            snap = self.read_snapshot(snap.prev_snapshot)
        return snap

    def snapshot_history(self) -> List[TableSnapshot]:
        """Head-first chain of all reachable snapshots (fuse_snapshot)."""
        out = []
        snap = self.read_snapshot()
        while snap is not None:
            out.append(snap)
            snap = (self.read_snapshot(snap.prev_snapshot)
                    if snap.prev_snapshot else None)
        return out

    def flashback(self, point) -> TableSnapshot:
        """FLASHBACK TABLE ... TO: repoint the head to an older snapshot
        (reference operations/revert.rs). OCC on the catalog seq."""
        target = self.navigate(point if isinstance(point, tuple)
                               else ("snapshot", point))
        if target is None:
            raise StorageOther("flashback target snapshot not found")
        _, seq = self.catalog.get_snapshot_location(self.info.table_id)
        self.catalog.set_snapshot_location(
            self.info.table_id, f"_ss/{target.snapshot_id}.json", seq)
        return target

    def read_segments(self, snapshot: TableSnapshot) -> List[SegmentInfo]:
        return [SegmentInfo.from_dict(read_json(self.abs_path(s)))
                for s in snapshot.segments]

    # ----------------------------------------------------------------- write
    def append(self, block: DataBlock, overwrite: bool = False) -> TableSnapshot:
        """Write a DataBlock (splitting into row_per_block chunks), build
        per-block indexes, commit a new snapshot (OCC with retry)."""
        with span("fuse_append", rows=block.num_rows):
            with span("fuse_normalize"):
                block = self._normalize_block(block)
            with span("fuse_cluster_sort"):
                block, cluster_runs = self._cluster_sort(block)
            rpb = self.row_per_block()
            metas: List[BlockMeta] = []
            for start, end in _block_spans(block.num_rows, rpb, cluster_runs):
                chunk = block.slice(start, end)
                if chunk.num_rows == 0:
                    continue
                metas.append(self._write_block(chunk))
            with span("fuse_commit"):
                segment_loc = None
                if metas:
                    segment_loc = f"_sg/{new_uuid()}.json"
                    write_json(self.abs_path(segment_loc),
                               SegmentInfo(metas).to_dict())
                return self._commit([segment_loc] if segment_loc else [],
                                    overwrite)

    def _normalize_block(self, block: DataBlock) -> DataBlock:
        """Project/reorder columns to the table schema, fill defaults."""
        from ...expression.evaluator import cast_column, constant_column
        cols = []
        names = []
        for f in self.schema.fields:
            names.append(f.name)
            if block.has_column(f.name):
                col = block.column(f.name)
                if col.dtype.remove_nullable() != f.dtype.remove_nullable():
                    col = cast_column(col, f.dtype, False)
                cols.append(col)
            else:
                cols.append(constant_column(f.default, f.dtype.wrap_nullable(),
                                            block.num_rows))
        return DataBlock(names, cols, block.num_rows)

    def _cluster_sort(self, block: DataBlock):
        """CLUSTER BY handling at write (reference TransformVectorCluster,
        transform_vector_cluster.rs:29-141): vector keys -> k-means sort by
        (cluster_id, distance-to-centroid) returning cluster run lengths so
        ``append`` splits blocks at CLUSTER boundaries (blocks then carry
        tight centroid/radius stats and the routing prune bites); scalar
        keys -> plain lexsort. Returns (block, cluster_runs-or-None)."""
        import numpy as np
        from ...types import VectorType
        if not self.info.cluster_by or block.num_rows <= 1:
            return block, None
        key = self.info.cluster_by[0]
        if not block.has_column(key):
            return block, None
        col = block.column(key)
        if isinstance(col.dtype.remove_nullable(), VectorType):
            from ...index.kmeans import MAX_CLUSTERS, cluster_layout
            # reference operating point: 64 clusters per <=262,144-row
            # batch (transform_vector_cluster.rs); aligned packing below
            # merges whole adjacent clusters into rpb-sized blocks
            order, runs = cluster_layout(
                np.asarray(col.data, dtype=np.float32), k=MAX_CLUSTERS)
            return block.take(order), runs
        # scalar cluster keys: lexsort (minor->major)
        keys = []
        for k in reversed(self.info.cluster_by):
            if not block.has_column(k):
                continue
            c = block.column(k)
            from ...expression import StringData
            arr = (np.array(c.data.to_pylist(), dtype=object)
                   if isinstance(c.data, StringData) else np.asarray(c.data))
            keys.append(arr)
        if not keys:
            return block, None
        return block.take(np.lexsort(keys)), None

    def _write_block(self, chunk: DataBlock) -> BlockMeta:
        uid = new_uuid()
        rel = f"_b/{uid}.parquet"
        OPERATOR.makedirs(self.abs_path("_b"))
        with span("fuse_write_block", rows=chunk.num_rows):
            size = block_io.write_block(self.abs_path(rel), chunk)
        with span("fuse_block_indexes"):
            meta = BlockMeta(rel, chunk.num_rows, size, block_stats(chunk))
            self._build_block_indexes(meta, chunk, uid)
        return meta

    # ------------------------------------------------------------ index build
    def _build_block_indexes(self, meta: BlockMeta, chunk: DataBlock, uid: str):
        from ...index.bloom import build_column_bloom
        # bloom filters for eligible columns (reference BloomIndexState)
        bloom_cols = {}
        OPERATOR.makedirs(self.abs_path("_i"))
        for name, col in chunk.items():
            flt = build_column_bloom(col)
            if flt is not None:
                bloom_cols[name.lower()] = True
        if bloom_cols:
            rel = f"_i/{uid}.bloom.npz"
            self._write_bloom(self.abs_path(rel), chunk, bloom_cols)
            meta.bloom_index = {"location": rel, "columns": bloom_cols}
        # vector indexes
        for idx in self.info.vector_indexes():
            self._build_vector_index(meta, chunk, uid, idx)
        # inverted indexes
        for idx in self.info.inverted_indexes():
            self._build_inverted_index(meta, chunk, uid, idx)
        # aggregating indexes (materialized per-block aggregate partials)
        for idx in self.info.indexes.values():
            if idx.index_type == "AGGREGATING" and "aggs" in idx.options:
                self._build_agg_index(meta, chunk, uid, idx)
        # EE virtual columns: variant scalar leaf paths -> sidecar parquet
        self._build_virtual_columns(meta, chunk, uid)
        # ngram (LIKE) filters
        ngram_cols = {}
        for idx in self.info.ngram_indexes():
            from ...index.ngram import DEFAULT_GRAM, build_ngram_filter
            n = int(idx.options.get("gram_size", DEFAULT_GRAM))
            for cname in idx.columns:
                flt = build_ngram_filter(chunk.column(cname), n)
                if flt is not None:
                    ngram_cols[cname.lower()] = (flt, n)
        if ngram_cols:
            rel = f"_i/{uid}.ngram.npz"
            _buf = io.BytesIO()
            np.savez(_buf, **{
                c: np.frombuffer(f.to_bytes(), np.uint8)
                for c, (f, _) in ngram_cols.items()})
            OPERATOR.write_bytes(self.abs_path(rel), _buf.getvalue())
            meta.ngram_index = {"location": rel,
                                "columns": {c: n for c, (_, n) in ngram_cols.items()}}

    def _write_bloom(self, path: str, chunk: DataBlock, cols: Dict[str, bool]):
        import io as _io
        from ...index.bloom import build_column_bloom
        payload = {}
        for name in cols:
            flt = build_column_bloom(chunk.column(name))
            payload[f"{name}.bits"] = flt.bits
            payload[f"{name}.num_bits"] = np.int64(flt.num_bits)
        buf = _io.BytesIO()
        np.savez_compressed(buf, **payload)
        OPERATOR.write_bytes(path, buf.getvalue())

    def load_bloom(self, meta: BlockMeta, col: str):
        from ...index.bloom import BloomFilter
        if meta.bloom_index is None or col not in meta.bloom_index.get("columns", {}):
            return None
        z = np.load(OPERATOR.open_read(self.abs_path(meta.bloom_index["location"])))
        if f"{col}.bits" not in z:
            return None
        return BloomFilter(z[f"{col}.bits"], int(z[f"{col}.num_bits"]))

    def _build_vector_index(self, meta: BlockMeta, chunk: DataBlock, uid: str,
                            idx: TableIndexDef):
        """Per-block vector index at write (reference VectorIndexBuilder).

        Divergence: centroid/radius STATS are always built (they drive the
        IVF-style block routing prune), but HNSW GRAPHS are only built when
        they can win at serving time — the exact scan beats graph traversal
        for every block up to GRAPH_BUILD_MIN_ROWS (1,048,576 rows: a top-10
        over 1M rows took 12.8-17.5 ms exact against 71-82 ms through one
        1M-row graph at ef = 40, recall 1.0 against 0.66; NVIDIA H100 80GB
        HBM3, 700.00 W; chip_smoke.py --gates), so building graphs for
        such blocks is pure write amplification. Index option
        graphs='always'|'auto'|'never' (default auto = only blocks above
        the gate)."""
        from ...index.hnsw import build_hnsw
        col_name = idx.columns[0]
        col = chunk.column(col_name)
        if not isinstance(col.dtype.remove_nullable(), VectorType):
            raise VectorError(f"vector index {idx.name} on non-vector column {col_name}")
        vectors = col.numpy().astype(np.float32)
        metrics = [m.strip() for m in idx.options.get("distance", "cosine").split(",")]
        m = int(idx.options.get("m", DEFAULT_HNSW_M))
        efc = int(idx.options.get("ef_construct", DEFAULT_EF_CONSTRUCT))
        entry = {"stats": vector_stats(vectors, metrics).to_dict(),
                 "graphs": {}, "column": col_name}
        graphs_mode = str(idx.options.get("graphs", "auto")).lower()
        want_graphs = (graphs_mode == "always"
                       or (graphs_mode == "auto"
                           and chunk.num_rows > GRAPH_BUILD_MIN_ROWS))
        # the centroid/radius stats ARE index payload (they live in the
        # block meta); count them so fuse_block.vector_index_size reflects
        # the real index footprint even in stats-only mode
        import json as _json
        size = len(_json.dumps(entry["stats"]))
        if want_graphs:
            # links_format='compressed' bitpacks neighbor deltas (the
            # reference GraphLinksFormat::Compressed analog); decode
            # rebuilds the dense HBM layout, so search is unaffected
            links_format = str(idx.options.get("links_format",
                                               "plain")).lower()
            for metric in metrics:
                g = build_hnsw(vectors, m=m, ef_construct=efc, metric=metric)
                rel = f"_i/{uid}.{idx.name}.{metric}.hnsw"
                size += g.save(self.abs_path(rel), format=links_format)
                entry["graphs"][metric] = rel
        entry["size"] = size
        meta.vector_indexes[idx.name] = entry

    def _build_agg_index(self, meta: BlockMeta, chunk: DataBlock, uid: str,
                         idx: TableIndexDef):
        """Materialize this block's aggregate partials (reference
        TableIndexType::Aggregating): one parquet sidecar with the group
        keys plus mergeable per-aggregate state columns — count: the count;
        sum/avg: (sum, non-null count); min/max: (extremum, non-null
        count). Merging partials across blocks is associative, so the
        scan-time path (executor._try_agg_index) combines them exactly."""
        import json as _json

        from ...expression.schema import DataField
        from ...pipeline.keys import composite_group, factorize_column
        spec = _json.loads(idx.options.get("aggs", "[]"))
        key_cols = [chunk.column(c) for c in idx.columns]
        n = chunk.num_rows
        local, rep_idx = composite_group(
            [factorize_column(c) for c in key_cols])
        g = len(rep_idx)
        names = list(idx.columns)
        cols = [c.take(rep_idx) for c in key_cols]
        for i, a in enumerate(spec):
            fn, colname = a["fn"], a["col"]
            if fn == "count":
                if colname is None:
                    cnt = np.bincount(local, minlength=g)
                else:
                    c = chunk.column(colname)
                    sel = (local if c.validity is None
                           else local[c.validity])
                    cnt = np.bincount(sel, minlength=g)
                names.append(f"a{i}")
                cols.append(Column.from_numpy(cnt.astype(np.int64)))
                continue
            c = chunk.column(colname)
            data = np.asarray(c.data, np.float64)
            valid = (np.ones(n, np.bool_) if c.validity is None
                     else np.asarray(c.validity))
            gsel = local[valid]
            vsel = data[valid]
            cnts = np.bincount(gsel, minlength=g)
            if fn in ("sum", "avg"):
                vals = np.bincount(gsel, weights=vsel, minlength=g)
            else:
                neutral = np.inf if fn == "min" else -np.inf
                vals = np.full(g, neutral)
                (np.minimum if fn == "min" else np.maximum).at(
                    vals, gsel, vsel)
            validity = cnts > 0
            names.append(f"a{i}")
            cols.append(Column(self._f64_nullable(), np.where(validity, vals, 0.0),
                               None if validity.all() else validity))
            names.append(f"a{i}_cnt")
            cols.append(Column.from_numpy(cnts.astype(np.int64)))
        sidecar = DataBlock(names, cols, g)
        rel = f"_i/{uid}.{idx.name}.agg"
        size = block_io.write_block(self.abs_path(rel), sidecar)
        meta.agg_indexes[idx.name] = {
            "location": rel, "size": size,
            "schema": [(nm, c.dtype.sql_name()) for nm, c in
                       zip(names, cols)]}

    @staticmethod
    def _f64_nullable():
        from ...types import Float64
        return Float64.wrap_nullable()

    def read_agg_index_block(self, meta: BlockMeta, idx: TableIndexDef,
                             entry: dict) -> DataBlock:
        """Cached read of one block's aggregating-index sidecar."""
        from ...expression.schema import DataField, TableSchema
        from ...types import parse_type_name
        cache = CacheManager.instance().blocks
        path = self.abs_path(entry["location"])
        schema = TableSchema([DataField(nm, parse_type_name(t))
                              for nm, t in entry["schema"]])
        return cache.get_or_load(path,
                                 lambda: block_io.read_block(path, schema))

    def _build_inverted_index(self, meta: BlockMeta, chunk: DataBlock, uid: str,
                              idx: TableIndexDef):
        from ...index.inverted.writer import build_inverted_index
        rel = f"_i/{uid}.{idx.name}.inv"
        size = build_inverted_index(
            self.abs_path(rel),
            [chunk.column(c) for c in idx.columns], idx.options)
        meta.inverted_indexes[idx.name] = {
            "location": rel, "columns": [c.lower() for c in idx.columns],
            "size": size}

    # ----------------------------------------------------------------- commit
    def _build_virtual_columns(self, meta: BlockMeta, chunk: DataBlock,
                               uid: str) -> None:
        """Extract variant scalar leaf paths into a sidecar parquet
        (reference virtual_column_builder.rs:145; EE-gated, opt-in via
        enable_experimental_virtual_column)."""
        from ...utils.current import current_session
        s = current_session()
        if s is None:
            return
        try:
            if not bool(s.settings.get("enable_experimental_virtual_column")):
                return
            from ...license import check_feature
            check_feature(s, "virtual_column")
        except Exception:
            return
        from .virtual_column import extract_virtual_columns
        side, vmetas = extract_virtual_columns(chunk)
        if side is None:
            return
        rel = f"_i/{uid}.virtual.parquet"
        OPERATOR.makedirs(self.abs_path("_i"))
        size = block_io.write_block(self.abs_path(rel), side)
        meta.virtual_column = {"location": rel, "size": size,
                               "columns": vmetas}

    def _commit(self, new_segments: List[str], overwrite: bool) -> TableSnapshot:
        """CAS the snapshot pointer; on conflict re-base (append-only merge),
        mirroring the reference's OCC retry (sink_commit.rs:791-808)."""
        last_err = None
        for _ in range(COMMIT_RETRIES):
            loc, seq = self.catalog.get_snapshot_location(self.info.table_id)
            prev = TableSnapshot.from_dict(read_json(self.abs_path(loc))) if loc else None
            segments = list(new_segments) if overwrite else \
                (prev.segments if prev else []) + list(new_segments)
            snap = self._make_snapshot(segments, prev)
            ss_loc = f"_ss/{snap.snapshot_id}.json"
            write_json(self.abs_path(ss_loc), snap.to_dict())
            try:
                self.catalog.set_snapshot_location(self.info.table_id, ss_loc, seq)
                return snap
            except TableVersionMismatched as e:
                last_err = e
                continue
        raise last_err

    def _make_snapshot(self, segments: List[str],
                       prev: Optional[TableSnapshot]) -> TableSnapshot:
        row_count = 0
        block_count = 0
        index_size = 0
        vc_registry = {}
        for s in segments:
            seg = SegmentInfo.from_dict(read_json(self.abs_path(s)))
            row_count += seg.row_count
            block_count += len(seg.blocks)
            for b in seg.blocks:
                index_size += sum(v.get("size", 0) for v in b.vector_indexes.values())
                index_size += sum(v.get("size", 0) for v in b.inverted_indexes.values())
                for c in (b.virtual_column or {}).get("columns", []):
                    vc_registry.setdefault(
                        c["name"], {"source": c["source"], "path": c["path"],
                                    "type": c["type"]})
        return TableSnapshot(new_uuid(), segments, row_count, block_count,
                             index_size, prev.snapshot_id if prev else None,
                             time.time(), schema=self.info.schema.to_dict(),
                             virtual_columns=vc_registry or None)

    def truncate(self) -> TableSnapshot:
        return self._commit([], overwrite=True)

    # -------------------------------------------------- mutations / rebuilds
    def delete_rows(self, filter_expr) -> int:
        """DELETE FROM ... WHERE: rewrite affected blocks
        (reference: fuse mutation pipeline, operations/mutation/).
        Returns number of rows deleted."""
        from ...expression.evaluator import Evaluator
        from .pruning.range_pruner import range_should_keep
        return self._mutate_blocks(filter_expr, mode="delete")

    def update_rows(self, filter_expr, assignments) -> int:
        """UPDATE ... SET col=expr WHERE ...; assignments: [(col, ScalarExpr)]."""
        return self._mutate_blocks(filter_expr, mode="update", assignments=assignments)

    def _mutate_blocks(self, filter_expr, mode: str, assignments=None) -> int:
        import numpy as np
        from ...expression.evaluator import Evaluator, cast_column
        from .pruning.range_pruner import range_should_keep
        snap = self.read_snapshot()
        if snap is None:
            return 0
        affected = 0
        new_segments: List[str] = []
        for seg_loc in snap.segments:
            seg = SegmentInfo.from_dict(read_json(self.abs_path(seg_loc)))
            new_metas: List[BlockMeta] = []
            changed = False
            for bm in seg.blocks:
                is_callable = callable(filter_expr) and not hasattr(filter_expr, "dtype")
                if filter_expr is not None and not is_callable \
                        and not range_should_keep(filter_expr, bm.col_stats):
                    new_metas.append(bm)
                    continue
                block = block_io.read_block(self.abs_path(bm.location), self.schema)
                if is_callable:
                    # python predicate: block -> bool mask (REPLACE INTO's
                    # typed conflict matcher takes this path)
                    mask = np.asarray(filter_expr(block), np.bool_)
                elif filter_expr is not None:
                    col = Evaluator(block).run(filter_expr)
                    mask = np.asarray(col.data, np.bool_)
                    if col.validity is not None:
                        mask = mask & col.validity
                else:
                    mask = np.ones(block.num_rows, np.bool_)
                hit = int(mask.sum())
                if hit == 0:
                    new_metas.append(bm)
                    continue
                affected += hit
                changed = True
                CacheManager.instance().blocks.invalidate(self.abs_path(bm.location))
                if mode == "delete":
                    remaining = block.filter(~mask)
                    if remaining.num_rows:
                        new_metas.append(self._write_block(remaining))
                else:  # update
                    ev = Evaluator(block)
                    cols = {}
                    for col_name, expr in assignments:
                        f = self.schema.field(col_name)
                        newc = cast_column(ev.run(expr), f.dtype, False)
                        old = block.column(f.name)
                        merged = _merge_column(old, newc, mask)
                        cols[f.name] = merged
                    for name, c in cols.items():
                        block = block.with_column(name, c)
                    new_metas.append(self._write_block(block))
            if changed:
                if new_metas:
                    loc = f"_sg/{new_uuid()}.json"
                    write_json(self.abs_path(loc), SegmentInfo(new_metas).to_dict())
                    new_segments.append(loc)
            else:
                new_segments.append(seg_loc)
        if affected:
            self._commit_replace(new_segments)
        return affected

    def _commit_replace(self, segments: List[str]):
        for _ in range(COMMIT_RETRIES):
            loc, seq = self.catalog.get_snapshot_location(self.info.table_id)
            prev = TableSnapshot.from_dict(read_json(self.abs_path(loc))) if loc else None
            snap = self._make_snapshot(segments, prev)
            ss_loc = f"_ss/{snap.snapshot_id}.json"
            write_json(self.abs_path(ss_loc), snap.to_dict())
            try:
                self.catalog.set_snapshot_location(self.info.table_id, ss_loc, seq)
                return snap
            except TableVersionMismatched:
                continue
        raise TableVersionMismatched("mutation commit failed after retries")

    def refresh_indexes(self, index_name: Optional[str] = None) -> int:
        """(Re)build per-block index sidecars for existing data
        (reference: RefreshTableIndexInterpreter +
        VectorIndexBuilder::finalize_with_existing). Returns blocks touched."""
        snap = self.read_snapshot()
        if snap is None:
            return 0
        wanted = [i for i in self.info.indexes.values()
                  if index_name is None or i.name == index_name]
        touched = 0
        new_segments = []
        for seg_loc in snap.segments:
            seg = SegmentInfo.from_dict(read_json(self.abs_path(seg_loc)))
            changed = False
            for bm in seg.blocks:
                missing = [i for i in wanted
                           if (i.index_type == "VECTOR" and i.name not in bm.vector_indexes)
                           or (i.index_type in ("INVERTED", "NGRAM")
                               and i.name not in bm.inverted_indexes)
                           or (i.index_type == "AGGREGATING"
                               and i.name not in bm.agg_indexes)]
                if not missing:
                    continue
                block = block_io.read_block(self.abs_path(bm.location), self.schema)
                uid = bm.location.split("/")[-1].split(".")[0]
                for idx in missing:
                    if idx.index_type == "VECTOR":
                        self._build_vector_index(bm, block, uid, idx)
                    elif idx.index_type == "AGGREGATING":
                        self._build_agg_index(bm, block, uid, idx)
                    else:
                        self._build_inverted_index(bm, block, uid, idx)
                touched += 1
                changed = True
            if changed:
                loc = f"_sg/{new_uuid()}.json"
                write_json(self.abs_path(loc), seg.to_dict())
                new_segments.append(loc)
            else:
                new_segments.append(seg_loc)
        if touched:
            self._commit_replace(new_segments)
        return touched

    def refresh_virtual_columns(self) -> int:
        """(Re)extract variant virtual columns for blocks that lack a
        sidecar (reference interpreter_virtual_column_refresh.rs).
        Returns blocks touched."""
        from ...types import VariantType
        from .virtual_column import extract_virtual_columns
        if not any(isinstance(f.dtype.remove_nullable(), VariantType)
                   for f in self.schema.fields):
            from ...errors import SemanticError
            raise SemanticError(
                "Virtual column only support variant type, but this table"
                " don't have variant type fields")
        snap = self.read_snapshot()
        if snap is None:
            return 0
        touched = 0
        new_segments = []
        for seg_loc in snap.segments:
            seg = SegmentInfo.from_dict(read_json(self.abs_path(seg_loc)))
            changed = False
            for bm in seg.blocks:
                if bm.virtual_column is not None:
                    continue
                block = block_io.read_block(self.abs_path(bm.location),
                                            self.schema)
                side, vmetas = extract_virtual_columns(block)
                if side is None:
                    continue
                uid = bm.location.split("/")[-1].split(".")[0]
                rel = f"_i/{uid}.virtual.parquet"
                OPERATOR.makedirs(self.abs_path("_i"))
                size = block_io.write_block(self.abs_path(rel), side)
                bm.virtual_column = {"location": rel, "size": size,
                                     "columns": vmetas}
                touched += 1
                changed = True
            if changed:
                loc = f"_sg/{new_uuid()}.json"
                write_json(self.abs_path(loc), seg.to_dict())
                new_segments.append(loc)
            else:
                new_segments.append(seg_loc)
        if touched:
            self._commit_replace(new_segments)
        return touched

    def compact(self) -> int:
        """OPTIMIZE TABLE ... COMPACT: merge small blocks up to row_per_block
        (reference: operations/compact.rs). Returns blocks after compaction."""
        snap = self.read_snapshot()
        if snap is None:
            return 0
        segments = self.read_segments(snap)
        blocks = [b for s in segments for b in s.blocks]
        rpb = self.row_per_block()
        small = [b for b in blocks if b.row_count < rpb]
        if len(small) <= 1:
            return len(blocks)
        keep = [b for b in blocks if b.row_count >= rpb]
        merged = DataBlock.concat([
            block_io.read_block(self.abs_path(b.location), self.schema) for b in small])
        new_metas = list(keep)
        for start in range(0, merged.num_rows, rpb):
            chunk = merged.slice(start, min(start + rpb, merged.num_rows))
            if chunk.num_rows:
                new_metas.append(self._write_block(chunk))
        loc = f"_sg/{new_uuid()}.json"
        write_json(self.abs_path(loc), SegmentInfo(new_metas).to_dict())
        self._commit_replace([loc])
        return len(new_metas)

    def recluster(self) -> int:
        """OPTIMIZE/ALTER TABLE ... RECLUSTER: re-sort the whole table by
        its cluster keys and rewrite blocks (reference: recluster
        operations). For vector cluster keys this re-runs the global
        k-means routing sort, restoring tight per-block centroid/radius
        stats after many small appends — the quality knob of the IVF-style
        big-shard path. Returns the block count after reclustering."""
        snap = self.read_snapshot()
        if snap is None:
            return 0
        if not self.info.cluster_by:
            return self.compact()
        segments = self.read_segments(snap)
        blocks = [b for s in segments for b in s.blocks]
        if not blocks:
            return 0
        whole = DataBlock.concat([
            block_io.read_block(self.abs_path(b.location), self.schema)
            for b in blocks])
        self.append(whole, overwrite=True)  # append = cluster sort + split
        new_snap = self.read_snapshot()
        return new_snap.block_count if new_snap else 0

    def vacuum(self, retention_days: float = 0.0) -> int:
        """Delete files unreferenced by retained snapshots (reference:
        operations/{gc,vacuum}.rs). The head snapshot is always retained;
        ``retention_days`` > 0 additionally keeps time-travel history newer
        than the cutoff (setting data_retention_time_in_days). Returns
        files removed."""
        cutoff = (time.time() - retention_days * 86400.0
                  if retention_days > 0 else None)
        live = set()
        snap = self.read_snapshot()
        keep_snaps = []
        while snap is not None:
            keep_snaps.append(snap)
            if cutoff is None or snap.timestamp < cutoff \
                    or snap.prev_snapshot is None:
                break
            try:
                snap = TableSnapshot.from_dict(
                    read_json(self.abs_path(f"_ss/{snap.prev_snapshot}.json")))
            except Exception:
                break
        for snap in keep_snaps:
            live.add(f"_ss/{snap.snapshot_id}.json")
            for seg_loc in snap.segments:
                live.add(seg_loc)
                seg = SegmentInfo.from_dict(read_json(self.abs_path(seg_loc)))
                for b in seg.blocks:
                    live.add(b.location)
                    if b.bloom_index:
                        live.add(b.bloom_index["location"])
                    for v in b.vector_indexes.values():
                        live.update(v.get("graphs", {}).values())
                    for v in b.inverted_indexes.values():
                        live.add(v["location"])
                    for v in b.agg_indexes.values():
                        live.add(v["location"])
        removed = 0
        for sub in ("_b", "_sg", "_ss", "_i"):
            d = self.abs_path(sub)
            for path in OPERATOR.list(d):
                rel = f"{sub}/{os.path.basename(path)}"
                if rel not in live:
                    OPERATOR.delete(path)
                    removed += 1
        return removed

    # ------------------------------------------------------------------ reads
    def read_partitions(self, pushdown: Optional[PushDownInfo] = None,
                        snapshot_id: Optional[str] = None):
        """Prune and return (PrunedBlock list, PruningStats)."""
        from .pruning.pruner import FusePruner
        snap = self.read_snapshot(snapshot_id)
        if snap is None:
            return [], None
        segments = self.read_segments(snap)
        pruner = FusePruner(self, pushdown)
        return pruner.prune(segments), pruner.stats

    def read_block(self, meta: BlockMeta,
                   projection: Optional[List[str]] = None) -> DataBlock:
        cache = CacheManager.instance().blocks
        # schema fingerprint in the key: ALTER TABLE ADD/DROP/RENAME COLUMN
        # must never serve blocks decoded under the old schema
        key = (self.abs_path(meta.location) + "#"
               + ",".join(f.name for f in self.schema.fields))

        def load():
            with span("fuse_read_block", rows=meta.row_count):
                return block_io.read_block(self.abs_path(meta.location),
                                           self.schema)

        blk = cache.get_or_load(key, load)
        if projection is not None:
            return blk.project([self.schema.field(n).name for n in projection])
        return blk

    # -------------------------------------------------------- vector serving
    def device_vectors(self, meta: BlockMeta, col_name: str, normalized: bool):
        """Block's vector column as a device-resident tensor (cached).

        Rows pad with zeros to the SPAN_QUANTUM grid, as in the reference;
        consumers mask padding by index (meta.row_count is the valid count)."""
        from ...ops.distance import normalize
        cm = CacheManager.instance().vector_columns
        key = (self.abs_path(meta.location), col_name.lower(), normalized)

        def load():
            col = self.read_block(meta, [col_name]).column(col_name)
            arr = np.asarray(col.numpy(), np.float32)
            rem = (-arr.shape[0]) % SPAN_QUANTUM
            if rem and arr.shape[0] > SPAN_QUANTUM // 4:
                arr = np.concatenate(
                    [arr, np.zeros((rem, arr.shape[1]), np.float32)], axis=0)
            dev = backend.to_device(arr)
            return normalize(dev) if normalized else dev

        return cm.get_or_load(key, load)

    def load_vector_graph(self, meta: BlockMeta, index_name: str, metric: str):
        from ...index.hnsw import HnswGraph
        entry = meta.vector_indexes.get(index_name)
        if entry is None:
            return None
        rel = entry["graphs"].get(metric)
        if rel is None:
            return None
        cm = CacheManager.instance().vector_indexes
        return cm.get_or_load(self.abs_path(rel),
                              lambda: HnswGraph.load(self.abs_path(rel)))

    def search_vector_index(self, meta: BlockMeta, info: VectorIndexInfo,
                            q: np.ndarray, limit: int):
        """Per-block HNSW search (reference VectorIndexReader::prune)."""
        from ...index.hnsw import hnsw_search
        from ...index.hnsw.search import postprocess_scores
        metric = info.func_name.replace("_distance", "")
        graph = self.load_vector_graph(meta, info.index_name, metric)
        if graph is None:
            return None
        col = meta.vector_indexes[info.index_name].get("column") or info.column
        x_dev = self.device_vectors(meta, col, normalized=(metric == "cosine"))
        k = min(limit, graph.num_points)
        dists, ids = hnsw_search(graph, x_dev, q, k)
        return postprocess_scores(dists, metric), ids

    def brute_force_block_scores(self, meta: BlockMeta, info: VectorIndexInfo,
                                 q: np.ndarray, limit: int):
        """Exact scan fallback for blocks without an index
        (reference HNSWIndex::generate_scores, hnsw.rs:120)."""
        metric = info.func_name.replace("_distance", "")
        x_dev = self.device_vectors(meta, info.column,
                                    normalized=(metric == "cosine"))
        k = min(limit, meta.row_count)
        vals, ids = _exact_topk_program(np.asarray(q, np.float32), x_dev,
                                        k, metric, n_valid=meta.row_count)
        return tuple(backend.to_numpy([vals, ids]))

    def stacked_device_vectors(self, metas: List[BlockMeta], col_name: str,
                               normalized: bool):
        """All listed blocks' vector columns as ONE device-resident
        ``[total, d]`` tensor (+ row offsets), cached per block SET. Used
        only for stable sets (the whole table); per-query pruned subsets go
        through the per-block path instead."""
        cm = CacheManager.instance().vector_columns
        locs = tuple(self.abs_path(m.location) for m in metas)
        key = ("stacked", locs, col_name.lower(), normalized)

        def load():
            from ...ops.distance import normalize
            # host assembly (NOT device_vectors: those pad to the quantum
            # grid, which would interleave dead rows mid-corpus)
            blocks = [self.read_block(m, [col_name]) for m in metas]
            with span("fuse_stack", blocks=len(metas)):
                arrs = [np.asarray(b.column(col_name).numpy(), np.float32)
                        for b in blocks]
                offsets = np.zeros(len(arrs) + 1, np.int64)
                for i, a in enumerate(arrs):
                    offsets[i + 1] = offsets[i] + a.shape[0]
                host = np.concatenate(arrs, axis=0) if len(arrs) > 1 \
                    else arrs[0]
            with span("fuse_upload"):
                dev = backend.to_device(host)
                return (normalize(dev) if normalized else dev), offsets

        return cm.get_or_load(key, load)

    def batch_exact_topk(self, metas: List[BlockMeta], info: VectorIndexInfo,
                         q: np.ndarray, limit: int, host_max_rows: int = 0):
        """One stacked exact scan over many blocks -> global top-k as
        [(block_idx, row_in_block, score)] (replaces the per-block loop +
        host merge; one device dispatch per query regardless of block count).
        Corpora <= ``host_max_rows`` are scored on the host instead: at
        4,096 rows the host scan is ahead (NVIDIA H100 80GB HBM3, 700.00 W;
        chip_smoke.py --gates)."""
        metric = info.func_name.replace("_distance", "")
        total = sum(m.row_count for m in metas)
        if total <= host_max_rows:
            per_block = self._host_block_scores(metas, info, q)
            flat = np.concatenate(per_block)
            k = min(limit, flat.shape[0])
            top = np.argpartition(flat, k - 1)[:k]
            top = top[np.argsort(flat[top], kind="stable")]
            offsets = np.cumsum([0] + [len(s) for s in per_block])
            return [(int(np.searchsorted(offsets, g, side="right") - 1),
                     int(g - offsets[np.searchsorted(offsets, g, side="right") - 1]),
                     float(flat[g])) for g in top.tolist()]
        qj = np.asarray(q, np.float32)
        if self._is_full_block_set(metas, total):
            # stable set: one program over the cached stacked corpus
            x_dev, offsets = self.stacked_device_vectors(
                metas, info.column, normalized=(metric == "cosine"))
            k = min(limit, int(x_dev.shape[0]))
            vals, ids = backend.to_numpy(
                list(_exact_topk_program(qj, x_dev, k, metric)))
            vals = vals[0]
            ids = ids[0]
            out = []
            for gid, s in zip(ids.tolist(), vals.tolist()):
                bi = int(np.searchsorted(offsets, gid, side="right") - 1)
                out.append((bi, gid - int(offsets[bi]), float(s)))
            return out
        # pruned subset: one scan per block, all enqueued before one fetch
        pend = []
        for m in metas:
            x_dev = self.device_vectors(m, info.column,
                                        normalized=(metric == "cosine"))
            k = min(limit, m.row_count)
            pend.extend(_exact_topk_program(qj, x_dev, k, metric,
                                            n_valid=m.row_count))
        fetched = backend.to_numpy(pend)
        out = []
        for bi in range(len(metas)):
            vals, ids = fetched[2 * bi], fetched[2 * bi + 1]
            for r, s in zip(ids[0].tolist(), vals[0].tolist()):
                out.append((bi, int(r), float(s)))
        out.sort(key=lambda t: t[2])
        return out[:limit]

    def batch_generate_scores(self, metas: List[BlockMeta],
                              info: VectorIndexInfo,
                              host_max_rows: int = 0) -> List[np.ndarray]:
        """Exact scores for EVERY row of every listed block in one device
        program (the filtered-KNN / DESC / score-only path; reference
        generate_scores, vector_index_pruner.rs:305-398). Returns one f32
        array per block. Small corpora run on the host (see batch_exact_topk)."""
        metric = info.func_name.replace("_distance", "")
        q = np.asarray(info.query_values, np.float32)[None, :]
        total = sum(m.row_count for m in metas)
        if total <= host_max_rows:
            return self._host_block_scores(metas, info, q)
        if self._is_full_block_set(metas, total):
            x_dev, offsets = self.stacked_device_vectors(
                metas, info.column, normalized=(metric == "cosine"))
            scores = backend.to_numpy(
                _stacked_scores_program(q, x_dev, metric))[0]
            return [scores[offsets[i]:offsets[i + 1]]
                    for i in range(len(metas))]
        # pruned subset: per-block scans, one fetch; slice off the quantum
        # padding rows
        pend = []
        for m in metas:
            x_dev = self.device_vectors(m, info.column,
                                        normalized=(metric == "cosine"))
            pend.append(_stacked_scores_program(q, x_dev, metric)
                        [0, :m.row_count])
        return backend.to_numpy(pend)

    def _is_full_block_set(self, metas: List[BlockMeta], total: int) -> bool:
        """True when metas covers the head snapshot's whole corpus (the
        stacked-corpus cache is then stable across queries)."""
        try:
            snap = self.read_snapshot()
            return snap is not None and total == snap.row_count \
                and len(metas) == snap.block_count
        except Exception:
            return False

    def _host_block_scores(self, metas: List[BlockMeta],
                           info: VectorIndexInfo,
                           q: np.ndarray) -> List[np.ndarray]:
        """numpy exact scoring per block (the small-corpus serving path)."""
        metric = info.func_name.replace("_distance", "")
        q32 = np.asarray(q, np.float32)[0]
        cm = CacheManager.instance().vector_columns
        out = []
        for m in metas:
            key = ("host", self.abs_path(m.location), info.column.lower())
            x = cm.get_or_load(key, lambda m=m: np.ascontiguousarray(
                self.read_block(m, [info.column]).column(info.column).numpy(),
                dtype=np.float32))
            if metric == "cosine":
                nx = np.linalg.norm(x, axis=1)
                nq = np.linalg.norm(q32)
                denom = np.maximum(nx * nq, 1e-30)
                out.append((1.0 - (x @ q32) / denom).astype(np.float32))
            elif metric == "l2":
                d = x - q32[None, :]
                out.append(np.sqrt(np.einsum("nd,nd->n", d, d)).astype(np.float32))
            elif metric == "l1":
                out.append(np.abs(x - q32[None, :]).sum(axis=1).astype(np.float32))
            else:  # ip
                out.append((-(x @ q32)).astype(np.float32))
        return out

    def search_inverted(self, meta: BlockMeta, info):
        """Per-block full-text search -> (rows, scores) or None if no index."""
        from ...index.inverted.reader import search_block
        entry = meta.inverted_indexes.get(info.index_name) if info.index_name \
            else next(iter(meta.inverted_indexes.values()), None)
        if entry is None:
            return None
        cm = CacheManager.instance().inverted_indexes
        reader = cm.get_or_load(self.abs_path(entry["location"]),
                                lambda: _load_inverted(self.abs_path(entry["location"])))
        return search_block(reader, info)


def _load_inverted(path: str):
    from ...index.inverted.reader import InvertedBlockReader
    return InvertedBlockReader.load(path)


# rows of the [chunk, N] score block: ~1 GB of f32 scores at N = 1M
_QUERY_CHUNK = 256


def _exact_topk_program(q, x: torch.Tensor, k: int, metric: str,
                        n_valid=None, x_sq_norms=None):
    """Exact top-k of ``q [B, d]`` against ``x``, per chunk of
    ``_QUERY_CHUNK`` queries: the product block, then
    ``ops.exact_topk.exact_topk_select`` (distances, index mask of the pad
    rows past ``n_valid``, k-select, in one pass) and, for l2, a diff-based
    re-score of the winners. Equal distances rank by ascending row id, as
    the reference's ``lax.top_k(-d, k)`` ranks them. ``x_sq_norms`` (l2):
    ``x``'s row norms, when the caller scans ``x`` more than once. Returns
    device tensors (vals ``[B, k]`` f32, ids int32); one chunk's block is
    alive at a time."""
    from ...ops.exact_topk import exact_topk
    qd = q if isinstance(q, torch.Tensor) else backend.to_device(
        np.asarray(q, np.float32))
    # rows past n_valid are block padding (device arrays pad to the
    # SPAN_QUANTUM grid): masked by INDEX — no pad value is safe for every
    # metric
    parts = [exact_topk(qb, x, k, metric, x_sq_norms=x_sq_norms,
                        x_normalized=(metric == "cosine"), n_valid=n_valid)
             for qb in torch.split(qd, _QUERY_CHUNK)]
    vals = torch.cat([v for v, _ in parts])
    ids = torch.cat([i for _, i in parts])
    if metric == "l2":
        vals = _rescore_l2(qd, x, ids)
    return vals, ids.to(torch.int32)


def _rescore_l2(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor):
    """Exact diff-based l2 of the winners ``ids [B, k]``: the norm-expansion
    form cancels catastrophically for tiny distances."""
    diff = x[ids] - q[:, None, :]                             # [B, k, d]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, -1), 0.0))


def _stacked_scores_program(q, x: torch.Tensor, metric: str) -> torch.Tensor:
    """``[B, N]`` exact scores of ``q`` against every row of ``x``."""
    from ...ops.distance import pairwise_distance
    qd = q if isinstance(q, torch.Tensor) else backend.to_device(
        np.asarray(q, np.float32))
    return pairwise_distance(qd, x, metric, x_normalized=(metric == "cosine"))


class AttachedTable(FuseTable):
    """Read-only table over another table's storage directory.

    Reference: EE ATTACH TABLE (src/query/ee/src/attach_table) — the
    attached side reads the source's snapshots live (updates on the source
    become visible) and rejects every mutation. The head snapshot is the
    newest ``_ss/*.json`` by commit timestamp: the dir itself is the truth,
    no shared catalog pointer is required.
    """

    def __init__(self, info, catalog, data_root: str):
        self.info = info
        self.catalog = catalog
        self.table_dir = info.options["attach_location"]

    @staticmethod
    def head_snapshot_of(location: str) -> Optional[TableSnapshot]:
        ss_dir = os.path.join(location, "_ss")
        if OPERATOR.is_object_store(location):
            names = [k for k in OPERATOR.list(ss_dir) if k.endswith(".json")]
        else:
            if not os.path.isdir(ss_dir):
                return None
            names = [os.path.join(ss_dir, n) for n in os.listdir(ss_dir)
                     if n.endswith(".json")]
        head = None
        for path in names:
            snap = TableSnapshot.from_dict(read_json(path))
            if head is None or snap.timestamp > head.timestamp:
                head = snap
        return head

    def read_snapshot(self, snapshot_id=None) -> Optional[TableSnapshot]:
        if isinstance(snapshot_id, tuple):
            return self.navigate(snapshot_id)
        if snapshot_id:
            return super().read_snapshot(snapshot_id)
        return self.head_snapshot_of(self.table_dir)

    def _read_only(self, *_a, **_k):
        raise UnsupportedFeature("attached tables are read-only")

    append = truncate = delete_rows = update_rows = _read_only
    flashback = compact = vacuum = _read_only


def _merge_column(old: Column, new: Column, mask) -> Column:
    """old where ~mask, new where mask (UPDATE row merge)."""
    import numpy as np
    from ...expression.column import StringData
    va = old.validity if old.validity is not None else np.ones(len(old), bool)
    vb = new.validity if new.validity is not None else np.ones(len(new), bool)
    validity = np.where(mask, vb, va)
    if isinstance(old.data, StringData) or isinstance(new.data, StringData):
        ol, nl = old.to_pylist(), new.to_pylist()
        vals = [n if m else o for m, o, n in zip(mask, ol, nl)]
        return Column.from_pylist(vals, old.dtype)
    if isinstance(old.data, np.ndarray) and old.data.ndim == 2:
        payload = np.where(mask[:, None], new.data, old.data)
    else:
        payload = np.where(mask, new.data.astype(old.data.dtype), old.data)
    return Column(old.dtype.remove_nullable(), payload,
                  None if validity.all() else validity)
