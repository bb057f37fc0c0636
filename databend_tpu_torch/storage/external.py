"""External table engines: files that live OUTSIDE fuse snapshots.

Reference analogs: src/query/storages/{parquet,hive,delta,orc} — tables
whose data is a directory of files in an open format, read in place with
no snapshot/commit machinery. Supported engines:

  * PARQUET / ORC / CSV / TSV / NDJSON / AVRO — ``LOCATION='path'`` is a
    file or directory (recursive); one file = one scan block.
  * HIVE — directory tree with ``key=value`` partition directories;
    partition columns materialize from the path (reference
    storages/hive); ``format='parquet'`` option picks the file format.
  * DELTA — Delta Lake table: the live file set comes from replaying
    ``_delta_log/*.json`` add/remove actions (reference storages/delta;
    parquet checkpoints are not consumed — tables with only JSON commits,
    which includes every freshly-written table, read correctly).

The declared column list is the schema (the reference infers it from the
table metadata; declaring it keeps the binder's type checking exact).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..catalog.pushdown import PushDownInfo
from ..errors import BadArguments, StorageOther
from ..expression import DataBlock
from ..expression.schema import TableSchema
from ..utils.cache import CacheManager

_FILE_ENGINES = ("PARQUET", "ORC", "CSV", "TSV", "NDJSON", "AVRO")
EXTERNAL_ENGINES = _FILE_ENGINES + ("HIVE", "DELTA", "ICEBERG", "PAIMON")


class ExternalBlockMeta:
    """One file of the external table (quacks like fuse BlockMeta where
    the scan path looks: location, row_count, col_stats, index dicts)."""

    def __init__(self, path: str, row_count: int = -1,
                 partition_values: Optional[dict] = None):
        self.location = path
        self.row_count = row_count  # -1 = unknown until read
        self.col_stats: dict = {}
        self.vector_indexes: dict = {}
        self.inverted_indexes: dict = {}
        self.agg_indexes: dict = {}
        self.bloom_index = None
        self.ngram_index = None
        self.partition_values = partition_values or {}


class ExternalTable:
    """Read-only table over external files (Table trait analog)."""

    def __init__(self, info, catalog=None, data_root: str = ""):
        self.info = info
        self.engine = info.engine.upper()
        loc = info.options.get("location")
        if not loc:
            raise BadArguments(
                f"external table {info.name!r} needs LOCATION='path'")
        self.location = loc
        self.fmt = str(info.options.get(
            "format", self.engine if self.engine in _FILE_ENGINES
            else "PARQUET")).upper()

    # ------------------------------------------------------------------ meta
    @property
    def schema(self) -> TableSchema:
        return self.info.schema

    def read_snapshot(self, snapshot_id=None):
        return None

    def append(self, block, overwrite: bool = False):
        from ..errors import UnsupportedFeature
        raise UnsupportedFeature(
            f"table {self.info.name!r} (engine {self.engine}) is external"
            " and read-only")

    # ----------------------------------------------------------------- files
    def _data_files(self) -> List[ExternalBlockMeta]:
        if self.engine == "DELTA":
            return self._delta_files()
        if self.engine == "ICEBERG":
            return self._iceberg_files()
        if self.engine == "PAIMON":
            return self._paimon_files()
        exts = {"PARQUET": (".parquet", ".pq"), "ORC": (".orc",),
                "CSV": (".csv",), "TSV": (".tsv",),
                "NDJSON": (".ndjson", ".jsonl", ".json"),
                "AVRO": (".avro",)}[self.fmt]
        out = []
        if os.path.isfile(self.location):
            return [ExternalBlockMeta(self.location)]
        for root, _, files in os.walk(self.location):
            parts = _hive_partition_values(
                os.path.relpath(root, self.location)) \
                if self.engine == "HIVE" else {}
            for f in sorted(files):
                if f.startswith((".", "_")):
                    continue
                if not f.lower().endswith(exts):
                    continue
                out.append(ExternalBlockMeta(os.path.join(root, f),
                                             partition_values=parts))
        return out

    def _delta_files(self) -> List[ExternalBlockMeta]:
        log_dir = os.path.join(self.location, "_delta_log")
        if not os.path.isdir(log_dir):
            raise StorageOther(f"{self.location}: no _delta_log directory")
        live: dict = {}
        for name in sorted(os.listdir(log_dir)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(log_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    action = json.loads(line)
                    if "add" in action:
                        a = action["add"]
                        live[a["path"]] = ExternalBlockMeta(
                            os.path.join(self.location, a["path"]),
                            partition_values=a.get("partitionValues", {}))
                    elif "remove" in action:
                        live.pop(action["remove"]["path"], None)
        return [live[k] for k in sorted(live)]

    # --------------------------------------------------------------- iceberg
    def _iceberg_files(self) -> List[ExternalBlockMeta]:
        """Live data files of an Iceberg table: current snapshot ->
        manifest list (avro) -> manifests (avro) -> data files.
        Reference: src/query/storages/iceberg (via the iceberg-rust crate);
        here the table format spec is walked directly with the built-in
        Avro decoder."""
        from ..formats.avro import read_avro_records
        meta = _iceberg_latest_metadata(self.location)
        snap_id = meta.get("current-snapshot-id")
        snap = next((s for s in meta.get("snapshots", [])
                     if s.get("snapshot-id") == snap_id), None)
        if snap is None:
            return []
        ml = _iceberg_localize(snap["manifest-list"], self.location)
        out: List[ExternalBlockMeta] = []
        for m in read_avro_records(ml):
            mp = _iceberg_localize(m["manifest_path"], self.location)
            for e in read_avro_records(mp):
                if e.get("status") == 2:  # DELETED
                    continue
                df = e["data_file"]
                if df.get("content", 0) != 0:  # 1/2 = delete files (v2)
                    continue
                path = _iceberg_localize(df["file_path"], self.location)
                out.append(ExternalBlockMeta(
                    path, row_count=int(df.get("record_count", -1))))
        return sorted(out, key=lambda b: b.location)

    # --------------------------------------------------------------- paimon
    def _paimon_files(self) -> List[ExternalBlockMeta]:
        """Live data files of an Apache Paimon table: snapshot/LATEST ->
        snapshot-N JSON -> base+delta manifest lists (avro) -> manifest
        entries (_KIND 0=add 1=delete) reconciled by file name.
        Reference: src/query/storages (paimon external engine). Partition
        paths are resolved through a filename index (the serialized
        BinaryRow partition key is not re-derived)."""
        from ..formats.avro import read_avro_records
        snap = _paimon_latest_snapshot(self.location)
        live: dict = {}
        index = _paimon_file_index(self.location)
        for key in ("baseManifestList", "deltaManifestList"):
            ml = snap.get(key)
            if not ml:
                continue
            ml_path = os.path.join(self.location, "manifest", ml)
            if not os.path.isfile(ml_path):
                continue
            for m in read_avro_records(ml_path):
                name = m.get("_FILE_NAME") or m.get("fileName")
                if not name:
                    continue
                mpath = os.path.join(self.location, "manifest",
                                     os.path.basename(name))
                if not os.path.isfile(mpath):
                    continue
                for e in read_avro_records(mpath):
                    kind = e.get("_KIND", e.get("kind", 0))
                    f = e.get("_FILE") or e.get("file") or {}
                    fname = f.get("_FILE_NAME") or f.get("fileName")
                    if not fname:
                        continue
                    if kind == 0:
                        path = index.get(os.path.basename(fname))
                        if path:
                            live[os.path.basename(fname)] = \
                                ExternalBlockMeta(
                                    path,
                                    row_count=int(f.get("_ROW_COUNT",
                                                        f.get("rowCount",
                                                              -1))))
                    else:
                        live.pop(os.path.basename(fname), None)
        return [live[k] for k in sorted(live)]

    # ----------------------------------------------------------------- reads
    def read_partitions(self, pushdown: Optional[PushDownInfo] = None,
                        snapshot_id=None):
        from .fuse.pruning.pruner import PrunedBlock, PruningStats
        metas = self._data_files()
        stats = PruningStats()
        stats.blocks_before = len(metas)
        # partition pruning: equality predicates on partition columns
        pd = pushdown or PushDownInfo()
        if pd.filters is not None:
            eq = _equality_conjuncts(pd.filters)
            kept = []
            for m in metas:
                ok = True
                for col, val in eq:
                    pv = m.partition_values.get(col)
                    if pv is not None and str(pv) != str(val):
                        ok = False
                        break
                if ok:
                    kept.append(m)
            metas = kept
        stats.blocks_after = len(metas)
        return [PrunedBlock(m) for m in metas], stats

    def read_block(self, meta: ExternalBlockMeta,
                   projection: Optional[List[str]] = None) -> DataBlock:
        from ..formats.registry import FileFormatOptions, read_file
        cache = CacheManager.instance().blocks
        key = ("ext", meta.location)
        part_cols = set(k.lower() for k in meta.partition_values)
        file_fields = [f for f in self.schema.fields
                       if f.name.lower() not in part_cols]

        def load():
            blk = read_file(meta.location, TableSchema(list(file_fields)),
                            FileFormatOptions(type=self.fmt))
            # materialize partition columns from the path (HIVE/DELTA)
            for f in self.schema.fields:
                pv = meta.partition_values.get(f.name) \
                    or meta.partition_values.get(f.name.lower())
                if f.name.lower() in part_cols:
                    from ..expression import Column
                    from ..expression.evaluator import cast_column
                    col = Column.from_pylist([pv] * blk.num_rows,
                                             _string_type())
                    if f.dtype.remove_nullable() != _string_type():
                        col = cast_column(col, f.dtype, False)
                    blk = blk.with_column(f.name, col)
            meta.row_count = blk.num_rows
            return blk.project([f.name for f in self.schema.fields])

        blk = cache.get_or_load(key, load)
        meta.row_count = blk.num_rows
        if projection is not None:
            return blk.project([self.schema.field(n).name
                                for n in projection])
        return blk


def _iceberg_latest_metadata(location: str) -> dict:
    """Resolve the current metadata JSON: version-hint.text when present,
    else the lexicographically-newest *.metadata.json."""
    md = os.path.join(location, "metadata")
    if not os.path.isdir(md):
        raise StorageOther(f"{location}: no iceberg metadata/ directory")
    hint = os.path.join(md, "version-hint.text")
    if os.path.isfile(hint):
        v = open(hint).read().strip()
        for cand in (f"v{v}.metadata.json", f"{v}.metadata.json"):
            p = os.path.join(md, cand)
            if os.path.isfile(p):
                return json.load(open(p))
    cands = sorted(n for n in os.listdir(md) if n.endswith(".metadata.json"))
    if not cands:
        raise StorageOther(f"{location}: no *.metadata.json found")
    return json.load(open(os.path.join(md, cands[-1])))


def _iceberg_localize(path: str, location: str) -> str:
    """Map a (possibly absolute file:// URI from another machine) iceberg
    path to this table's directory."""
    p = path
    if p.startswith("file://"):
        p = p[len("file://"):]
    if os.path.exists(p):
        return p
    # remap by the last metadata/ or data/ component
    for marker in ("/metadata/", "/data/"):
        if marker in p:
            return os.path.join(location, marker.strip("/"),
                                p.split(marker, 1)[1])
    return os.path.join(location, os.path.basename(p))


_ICEBERG_TYPES = {
    "boolean": "BOOLEAN", "int": "INT", "long": "BIGINT", "float": "FLOAT",
    "double": "DOUBLE", "string": "VARCHAR", "uuid": "VARCHAR",
    "binary": "VARCHAR", "date": "DATE", "timestamp": "TIMESTAMP",
    "timestamptz": "TIMESTAMP",
}


def iceberg_schema(location: str) -> TableSchema:
    """Infer the table schema from iceberg metadata JSON (reference:
    iceberg-rust schema conversion)."""
    from ..expression.schema import DataField
    from ..types import parse_type_name
    meta = _iceberg_latest_metadata(location)
    schema = None
    if "schemas" in meta:
        sid = meta.get("current-schema-id", 0)
        schema = next((s for s in meta["schemas"]
                       if s.get("schema-id") == sid), None)
    if schema is None:
        schema = meta.get("schema")
    if schema is None:
        raise StorageOther(f"{location}: iceberg metadata carries no schema")
    fields = []
    for f in schema.get("fields", []):
        t = f["type"]
        if isinstance(t, str):
            if t.startswith("decimal"):
                sql = t.upper().replace(" ", "")
            else:
                sql = _ICEBERG_TYPES.get(t, "VARCHAR")
        else:
            sql = "VARIANT"  # struct/list/map
        dtype = parse_type_name(sql)
        if not f.get("required", False) and not dtype.is_nullable():
            dtype = dtype.wrap_nullable()
        fields.append(DataField(f["name"], dtype))
    return TableSchema(fields)


def _paimon_latest_snapshot(location: str) -> dict:
    snap_dir = os.path.join(location, "snapshot")
    if not os.path.isdir(snap_dir):
        raise StorageOther(f"{location}: no paimon snapshot directory")
    latest = os.path.join(snap_dir, "LATEST")
    sid = None
    if os.path.isfile(latest):
        try:
            sid = int(open(latest).read().strip())
        except ValueError:
            sid = None
    if sid is None:
        nums = [int(n.split("-", 1)[1]) for n in os.listdir(snap_dir)
                if n.startswith("snapshot-")
                and n.split("-", 1)[1].isdigit()]
        if not nums:
            raise StorageOther(f"{location}: no paimon snapshots")
        sid = max(nums)
    with open(os.path.join(snap_dir, f"snapshot-{sid}")) as f:
        return json.load(f)


def _paimon_file_index(location: str) -> dict:
    """filename -> absolute path over the table's data directories
    (everything except the snapshot/manifest/schema control dirs)."""
    out = {}
    skip = {"snapshot", "manifest", "schema", "index", "statistics"}
    for root, dirs, files in os.walk(location):
        if root == location:
            dirs[:] = [d for d in dirs if d not in skip]
        for f in files:
            if not f.startswith((".", "_")):
                out[f] = os.path.join(root, f)
    return out


_PAIMON_TYPES = {
    "INT": "INT", "INTEGER": "INT", "TINYINT": "INT", "SMALLINT": "INT",
    "BIGINT": "BIGINT", "FLOAT": "FLOAT", "DOUBLE": "DOUBLE",
    "BOOLEAN": "BOOLEAN", "DATE": "DATE", "STRING": "VARCHAR",
    "BYTES": "VARCHAR", "BINARY": "VARCHAR", "VARBINARY": "VARCHAR",
}


def paimon_schema(location: str) -> TableSchema:
    """Schema from the highest schema/schema-N JSON (paimon spec: fields
    carry SQL-ish type strings, `NOT NULL` marks requiredness)."""
    from ..expression.schema import DataField
    from ..types import parse_type_name
    sdir = os.path.join(location, "schema")
    if not os.path.isdir(sdir):
        raise StorageOther(f"{location}: no paimon schema directory")
    nums = [int(n.split("-", 1)[1]) for n in os.listdir(sdir)
            if n.startswith("schema-") and n.split("-", 1)[1].isdigit()]
    if not nums:
        raise StorageOther(f"{location}: no paimon schema files")
    with open(os.path.join(sdir, f"schema-{max(nums)}")) as f:
        meta = json.load(f)
    fields = []
    for fld in meta.get("fields", []):
        t = fld.get("type", "STRING")
        if not isinstance(t, str):
            sql = "VARIANT"
            required = False
        else:
            required = "NOT NULL" in t.upper()
            base = t.upper().replace("NOT NULL", "").strip()
            if base.startswith(("CHAR", "VARCHAR", "STRING")):
                sql = "VARCHAR"
            elif base.startswith("DECIMAL"):
                sql = base.replace(" ", "")
            elif base.startswith("TIMESTAMP"):
                sql = "TIMESTAMP"
            else:
                sql = _PAIMON_TYPES.get(base.split("(")[0], "VARCHAR")
        dtype = parse_type_name(sql)
        if not required and not dtype.is_nullable():
            dtype = dtype.wrap_nullable()
        fields.append(DataField(fld["name"], dtype))
    return TableSchema(fields)


def _string_type():
    from ..types import String
    return String


def _hive_partition_values(rel: str) -> dict:
    out = {}
    for seg in rel.split(os.sep):
        if "=" in seg:
            k, _, v = seg.partition("=")
            out[k] = v
    return out


def _equality_conjuncts(expr) -> List[Tuple[str, object]]:
    """(column, literal) pairs from AND-ed `col = const` predicates."""
    from ..expression.expr import BoundColumn, Constant, Func
    out = []

    def visit(e):
        if not isinstance(e, Func):
            return
        if e.name == "and":
            for a in e.args:
                visit(a)
            return
        if e.name == "eq" and len(e.args) == 2:
            a, b = e.args
            if isinstance(a, BoundColumn) and isinstance(b, Constant):
                out.append((a.name.lower(), b.value))
            elif isinstance(b, BoundColumn) and isinstance(a, Constant):
                out.append((b.name.lower(), a.value))

    visit(expr)
    return out
