"""system.* tables.

Reference analog: src/query/storages/system/src/ (46 system tables). Each
table is generated on demand from live engine state and bound as a values
plan, so the full SQL surface (filters, joins, aggregates) works over them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ..expression import Column, DataBlock, DataField
from ..types import Boolean, Float64, Int64, String


def _block(cols: List[Tuple[str, object, list]]) -> Tuple[DataBlock, List[DataField]]:
    names = [c[0] for c in cols]
    fields = [DataField(n, t) for n, t, _ in cols]
    n = len(cols[0][2]) if cols else 0
    columns = [Column.from_pylist(v, t.wrap_nullable()
                                  if any(x is None for x in v) else t)
               for _, t, v in cols]
    return DataBlock(names, columns, n), fields


def _sys_one(s):
    return _block([("dummy", Int64, [1])])


def _sys_databases(s):
    names = sorted(d.name for d in s.catalog.list_databases())
    return _block([("name", String, names)])


def _sys_tables(s):
    rows = []
    # the virtual system database's own tables come first (reference
    # tables_table.rs lists them alongside user tables)
    for name in sorted(SYSTEM_TABLES):
        rows.append(("system", name, "SystemTable", 0, 0, None, "", "",
                     None, None))
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            t = s.open_table(info)
            snap = t.read_snapshot()
            vsize = None
            if snap is not None and getattr(snap, "index_size", 0):
                vsize = snap.index_size
            rows.append((d.name, info.name, info.engine,
                         snap.row_count if snap else 0,
                         snap.block_count if snap else 0,
                         snap.snapshot_id if snap else None,
                         ",".join(info.cluster_by),
                         (info.options or {}).get("comment", ""),
                         vsize,
                         len(snap.segments) if snap else 0))
    cols = list(zip(*rows)) if rows else [[] for _ in range(10)]
    return _block([
        ("catalog", String, ["default"] * len(rows)),
        ("database", String, list(cols[0])), ("name", String, list(cols[1])),
        ("engine", String, list(cols[2])), ("num_rows", Int64, list(cols[3])),
        ("num_blocks", Int64, list(cols[4])),
        ("number_of_rows", Int64, list(cols[3])),
        ("number_of_blocks", Int64, list(cols[4])),
        ("number_of_segments", Int64,
         [x or 0 for x in cols[9]] if rows else []),
        ("snapshot_id", String, list(cols[5])),
        ("cluster_by", String, list(cols[6])),
        ("comment", String, list(cols[7])),
        ("vector_index_size", Int64.wrap_nullable(), list(cols[8]))])


def _sys_columns(s):
    rows = []
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            for f in info.schema.fields:
                rows.append((f.name, d.name, info.name,
                             f.dtype.sql_name(), f.dtype.is_nullable(),
                             None if f.default is None else str(f.default)))
    cols = list(zip(*rows)) if rows else [[] for _ in range(6)]
    return _block([
        ("name", String, list(cols[0])), ("database", String, list(cols[1])),
        ("table", String, list(cols[2])), ("type", String, list(cols[3])),
        ("is_nullable", Boolean, list(cols[4])),
        ("default_expression", String, list(cols[5]))])


def _sys_settings(s):
    rows = s.settings.all()
    return _block([
        ("name", String, [r[0] for r in rows]),
        ("value", String, [str(r[1]) for r in rows]),
        ("default", String, [str(r[2]) for r in rows]),
        ("description", String, [str(r[3]) for r in rows])])


def _sys_functions(s):
    from ..expression.functions import registry
    from ..expression.functions.aggregates import AGGREGATE_FUNCTIONS
    scalars = sorted(registry.names())
    aggs = sorted(AGGREGATE_FUNCTIONS)
    names = scalars + aggs
    return _block([
        ("name", String, names),
        ("is_aggregate", Boolean, [False] * len(scalars) + [True] * len(aggs))])


def _sys_metrics(s):
    from ..utils.metrics import METRICS
    snap = METRICS.snapshot()
    items = sorted(snap.items())
    return _block([
        ("metric", String, [k for k, _ in items]),
        ("value", Float64, [float(v) if not isinstance(v, dict) else float(v.get("sum", 0))
                            for _, v in items])])


def _sys_query_log(s):
    rows = list(getattr(s, "query_log", []))
    return _block([
        ("query_id", String, [r["query_id"] for r in rows]),
        ("query_text", String, [r["query_text"] for r in rows]),
        ("query_kind", String, [r["query_kind"] for r in rows]),
        ("query_start_time", Float64, [r["start"] for r in rows]),
        ("query_duration_ms", Float64, [r["duration_ms"] for r in rows]),
        ("result_rows", Int64, [r["result_rows"] for r in rows]),
        ("exception_text", String, [r["error"] for r in rows])])


def _sys_indexes(s):
    rows = []
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            for idx in info.indexes.values():
                rows.append((idx.name, idx.index_type.lower(), d.name,
                             info.name, ",".join(idx.columns)))
    cols = list(zip(*rows)) if rows else [[] for _ in range(5)]
    return _block([
        ("name", String, list(cols[0])), ("type", String, list(cols[1])),
        ("database", String, list(cols[2])), ("table", String, list(cols[3])),
        ("columns", String, list(cols[4]))])


def _sys_caches(s):
    from ..utils.cache import CacheManager
    cm = CacheManager.instance()
    named = {n: getattr(cm, n) for n in
             ("vector_columns", "vector_indexes", "bloom_filters",
              "inverted_indexes", "blocks")}
    rows = [(name, len(c), c.capacity, c.hits, c.misses)
            for name, c in sorted(named.items())]
    cols = list(zip(*rows)) if rows else [[] for _ in range(5)]
    return _block([
        ("name", String, list(cols[0])), ("num_items", Int64, list(cols[1])),
        ("capacity", Int64, list(cols[2])), ("hits", Int64, list(cols[3])),
        ("misses", Int64, list(cols[4]))])


def _sys_build_options(s):
    import torch

    from .. import backend
    from ..version import __version__
    devs = backend.devices()
    return _block([
        ("name", String, ["version", "torch_version", "device_platform",
                          "device_count"]),
        ("value", String, [__version__, torch.__version__,
                           ",".join(sorted({d.type for d in devs})),
                           str(len(devs))])])


def _sys_users(s):
    rows = [(u.name, "%",
             "no_password" if not u.password_sha256 else "sha256_password",
             ",".join(sorted(u.roles)))
            for u in s.users.list_users()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(4)]
    return _block([
        ("name", String, list(cols[0])), ("hostname", String, list(cols[1])),
        ("auth_type", String, list(cols[2])),
        ("default_role", String, list(cols[3]))])


def _sys_roles(s):
    rows = [(r.name, len(r.grants)) for r in s.users.list_roles()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(2)]
    return _block([("name", String, list(cols[0])),
                   ("inherited_roles", Int64, list(cols[1]))])


def _sys_catalogs(s):
    return _block([("name", String, ["default"])])


def _sys_engines(s):
    return _block([
        ("engine", String, ["FUSE", "VIEW", "SYSTEM", "STREAM"]),
        ("comment", String, [
            "snapshot storage over object store, TPU-served vector/text search",
            "named query", "live engine state", "CDC change tracking"])])


def _sys_clusters(s):
    """Registered server processes (reference clusters_table: query nodes
    from ClusterDiscovery) plus the devices as the data-plane rows."""
    from .. import backend
    rows = []
    try:
        from ..meta.cluster import ClusterDiscovery
        for n in ClusterDiscovery(s.meta).list_nodes():
            rows.append((n.node_id, n.address, f"server v{n.version} "
                         f"({n.device_count} devices)", 0))
    except Exception:
        pass
    rows += [(f"device-{i}", d.type, str(d), i)
             for i, d in enumerate(backend.devices())]
    cols = list(zip(*rows)) if rows else [[] for _ in range(4)]
    return _block([
        ("name", String, list(cols[0])), ("host", String, list(cols[1])),
        ("description", String, list(cols[2])),
        ("port", Int64, list(cols[3]))])


def _sys_processes(s):
    """Live running queries from the process registry (KILL QUERY targets
    these ids; reference processes_table.rs)."""
    import time as _t
    from ..utils.processes import list_running
    rows = sorted(list_running(), key=lambda e: e["start"])
    return _block([
        ("id", String, [e["id"] for e in rows]),
        ("user", String, [e["user"] for e in rows]),
        ("extra_info", String, [e["sql"] for e in rows]),
        ("elapsed_ms", Float64,
         [(_t.time() - e["start"]) * 1e3 for e in rows])])


def _sys_streams(s):
    rows = [(name.split("/")[-1], meta.get("database", ""),
             meta.get("table", ""), meta.get("watermark_snapshot"))
            for name, meta in s.streams.list()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(4)]
    return _block([
        ("name", String, list(cols[0])), ("database", String, list(cols[1])),
        ("table_name", String, list(cols[2])),
        ("snapshot_location", String, list(cols[3]))])


def _sys_tasks(s):
    rows = [(t.get("name", ""), t.get("state", ""), t.get("schedule") or "",
             t.get("sql", t.get("definition", "")))
            for t in s.tasks.list()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(4)]
    return _block([
        ("name", String, list(cols[0])), ("state", String, list(cols[1])),
        ("schedule", String, list(cols[2])),
        ("definition", String, list(cols[3]))])


def _sys_views(s):
    rows = []
    for key, v, _ in s.meta.list_prefix("views/"):
        _, db, name = key.split("/", 2)
        rows.append((db, name, v.get("sql", "") if isinstance(v, dict) else str(v)))
    cols = list(zip(*rows)) if rows else [[] for _ in range(3)]
    return _block([
        ("database", String, list(cols[0])), ("name", String, list(cols[1])),
        ("definition", String, list(cols[2]))])


def _sys_table_functions(s):
    return _block([("name", String, sorted(
        ["numbers", "fuse_snapshot", "fuse_segment", "fuse_block"]))])


def _sys_query_cache(s):
    rows = [(repr(k[0])[:128], ts) for k, (ts, _) in
            getattr(s, "_result_cache", {}).items()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(2)]
    return _block([("sql", String, list(cols[0])),
                   ("cached_at", Float64, list(cols[1]))])


def _sys_statistics(s):
    """ANALYZE-produced table statistics (reference statistics_table.rs)."""
    rows = []
    from ..statistics import load_table_stats
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            try:
                ts = load_table_stats(s, info.table_id)
            except Exception:
                ts = None
            if ts is None:
                continue
            for col, cs in sorted(getattr(ts, "columns", {}).items()):
                rows.append((d.name, info.name, col,
                             float(getattr(cs, "ndv", 0.0)),
                             int(getattr(cs, "null_count", 0)),
                             len(getattr(cs, "counts", []) or [])))
    cols = list(zip(*rows)) if rows else [[] for _ in range(6)]
    return _block([
        ("database", String, list(cols[0])), ("table", String, list(cols[1])),
        ("column", String, list(cols[2])), ("ndv", Float64, list(cols[3])),
        ("null_count", Int64, list(cols[4])),
        ("histogram_buckets", Int64, list(cols[5]))])


def _sys_locks(s):
    return _block([("table_id", Int64, []), ("status", String, []),
                   ("user", String, [])])


def _sys_temp_files(s):
    import glob
    import os
    import tempfile
    rows = []
    for pat in ("dbtpu_spill_*", "dbtpu_aggspill_*", "dbtpu_joinspill_*"):
        for d in glob.glob(os.path.join(tempfile.gettempdir(), pat)):
            for f in glob.glob(os.path.join(d, "*")):
                rows.append((f, os.path.getsize(f)))
    cols = list(zip(*rows)) if rows else [[] for _ in range(2)]
    return _block([("file_name", String, list(cols[0])),
                   ("file_content_length", Int64, list(cols[1]))])


def _sys_configs(s):
    cfg = getattr(s, "config", None)
    rows = []
    if cfg is not None:
        for k, v in sorted(vars(cfg).items()):
            rows.append((k, str(v)))
    cols = list(zip(*rows)) if rows else [[] for _ in range(2)]
    return _block([("name", String, list(cols[0])),
                   ("value", String, list(cols[1]))])


def _sys_contributors(s):
    return _block([("name", String, ["databend_tpu developers"])])


def _sys_trace_spans(s):
    """Recent query spans (reference: fastrace spans surfaced via
    system_history; here an in-process recorder, utils/tracing.py)."""
    from ..utils.tracing import RECORDER
    spans = RECORDER.snapshot()
    return _block([
        ("query_id", String, [sp.query_id for sp in spans]),
        ("name", String, [sp.name for sp in spans]),
        ("path", String, [sp.path() for sp in spans]),
        ("duration_ms", Float64, [sp.duration_ms for sp in spans]),
        ("error", String, [sp.attrs.get("error") for sp in spans])])


def _sys_stages(s):
    """Reference: src/query/storages/system/src/stages_table.rs."""
    infos = s.stages.list()
    return _block([
        ("name", String, [i.name for i in infos]),
        ("stage_type", String, [i.stage_type for i in infos]),
        ("url", String, [i.url for i in infos]),
        ("number_of_files", Int64,
         [len(s.stages.list_files("@" + i.name)) for i in infos]),
        ("comment", String, [i.comment for i in infos])])


def _sys_sequences(s):
    infos = s.sequences.list()
    return _block([
        ("name", String, [i.name for i in infos]),
        ("start", Int64, [i.start for i in infos]),
        ("interval", Int64, [i.step for i in infos]),
        ("current", Int64, [i.current for i in infos]),
        ("comment", String, [i.comment for i in infos])])


def _sys_network_policies(s):
    infos = s.users.list_network_policies()
    return _block([
        ("name", String, [p["name"] for p in infos]),
        ("allowed_ip_list", String, [",".join(p["allowed"]) for p in infos]),
        ("blocked_ip_list", String, [",".join(p["blocked"]) for p in infos]),
        ("comment", String, [p.get("comment", "") for p in infos])])


def _sys_password_policies(s):
    infos = s.users.list_password_policies()
    return _block([
        ("name", String, [p["name"] for p in infos]),
        ("min_length", Int64, [p["min_length"] for p in infos]),
        ("max_length", Int64, [p["max_length"] for p in infos]),
        ("comment", String, [p.get("comment", "") for p in infos])])


def _sys_workload_groups(s):
    from .workload import WorkloadManager
    gs = WorkloadManager(s).list()
    return _block([
        ("name", String, [g["name"] for g in gs]),
        ("max_concurrency", String,
         [str(g["options"].get("max_concurrency", "")) for g in gs]),
        ("memory_quota", String,
         [str(g["options"].get("memory_quota", "")) for g in gs]),
        ("query_timeout", String,
         [str(g["options"].get("query_timeout", "")) for g in gs]),
        ("cpu_quota", String,
         [str(g["options"].get("cpu_quota", "")) for g in gs])])


def _sys_masking_policies(s):
    infos = s.policies.list_masking()
    return _block([
        ("name", String, [p.name for p in infos]),
        ("signature", String, [f"({p.arg_name} {p.arg_type})" for p in infos]),
        ("body", String, [p.body for p in infos]),
        ("comment", String, [p.comment for p in infos])])


def _sys_row_access_policies(s):
    infos = s.policies.list_row_access()
    return _block([
        ("name", String, [p.name for p in infos]),
        ("signature", String,
         ["(" + ", ".join(f"{n} {t}" for n, t in p.args) + ")" for p in infos]),
        ("body", String, [p.body for p in infos]),
        ("comment", String, [p.comment for p in infos])])


def _sys_dictionaries(s):
    infos = s.dictionaries.list()
    return _block([
        ("name", String, [i.name for i in infos]),
        ("key_names", String, [i.primary_key for i in infos]),
        ("attribute_names", String,
         [",".join(n for n, _ in i.columns) for i in infos]),
        ("source", String, [i.source_kind for i in infos]),
        ("comment", String, [i.comment for i in infos])])


def _sys_temp_tables(s):
    """Reference: src/query/storages/system temp_tables_table.rs."""
    opened = getattr(s, "_temp_open", None) or {}
    keys = sorted(opened)
    return _block([
        ("database", String, [k[0] for k in keys]),
        ("name", String, [k[1] for k in keys]),
        ("num_rows", Int64,
         [(opened[k].read_snapshot().row_count
           if opened[k].read_snapshot() else 0) for k in keys])])


def _sys_clustering_history(s):
    """Reference: clustering_history_table.rs — recluster operations."""
    rows = sorted((v for _, v, _ in s.meta.list_prefix("clustering_history/")),
                  key=lambda h: h["started"])
    return _block([
        ("table", String, [h["table"] for h in rows]),
        ("duration_ms", Float64, [h["duration_ms"] for h in rows]),
        ("blocks_before", Int64, [h["blocks_before"] for h in rows]),
        ("blocks_after", Int64, [h["blocks_after"] for h in rows])])


def _sys_procedures(s):
    """Reference: procedures_table.rs."""
    rows = sorted((v for _, v, _ in s.meta.list_prefix("procedures/")),
                  key=lambda p: p["name"])
    return _block([
        ("name", String, [p["name"] for p in rows]),
        ("arguments", String,
         [", ".join(f"{n} {t}" for n, t in p["args"]) for p in rows]),
        ("definition", String, [p["body"] for p in rows])])


def _sys_zero(s):
    """One row, value 0 (reference zero_table.rs, ClickHouse system.zero)."""
    return _block([("zero", Int64, [0])])


def _sys_malloc_stats(s):
    """Process memory stats (reference malloc_stats_table.rs; here the
    Python allocator + RSS take the jemalloc role)."""
    import resource
    import sys as _sys
    ru = resource.getrusage(resource.RUSAGE_SELF)
    names = ["max_rss_bytes", "gc_objects", "allocated_blocks"]
    vals = [ru.ru_maxrss * 1024, len(__import__("gc").get_objects()),
            _sys.getallocatedblocks()]
    return _block([("name", String, names),
                   ("value", Int64, [int(v) for v in vals])])


def _sys_backtrace(s):
    """Live thread stacks (reference backtrace_table.rs / async_backtrace)."""
    import sys as _sys
    import threading
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    rows = []
    for tid, frame in _sys._current_frames().items():
        stack = "".join(traceback.format_stack(frame, limit=16))
        rows.append((str(tid), names.get(tid, "?"), stack))
    return _block([
        ("thread_id", String, [r[0] for r in rows]),
        ("thread_name", String, [r[1] for r in rows]),
        ("stack", String, [r[2] for r in rows])])


def _sys_credits(s):
    """Third-party substrate versions (reference credits_table.rs)."""
    mods = []
    for name in ("torch", "numpy", "pyarrow"):
        try:
            m = __import__(name)
            mods.append((name, getattr(m, "__version__", "?")))
        except Exception:
            pass
    return _block([("name", String, [m[0] for m in mods]),
                   ("version", String, [m[1] for m in mods])])


def _sys_user_functions(s):
    """Lambda UDFs (reference user_functions_table.rs)."""
    rows = [(name, ",".join(v.get("params", [])), v.get("definition", ""))
            for name, v in sorted(s.udfs.items())]
    return _block([
        ("name", String, [r[0] for r in rows]),
        ("arguments", String, [r[1] for r in rows]),
        ("definition", String, [r[2] for r in rows])])


def _sys_query_execution(s):
    """Per-operator execution profile of recent queries (reference
    query_execution_table.rs fed by PlanProfile; here the span recorder)."""
    from ..utils.tracing import RECORDER
    spans = [sp for sp in RECORDER.snapshot() if sp.name == "execute"
             or "." in sp.path()]
    return _block([
        ("query_id", String, [sp.query_id for sp in spans]),
        ("operator", String, [sp.path() for sp in spans]),
        ("duration_ms", Float64, [sp.duration_ms for sp in spans])])


def _sys_constraints(s):
    """Table constraints (reference constraints_table.rs; constraints are
    not yet a DDL surface here, so the table is present but empty)."""
    return _block([
        ("database", String, []), ("table", String, []),
        ("name", String, []), ("type", String, []),
        ("expression", String, [])])


def _sys_malloc_stats_totals(s):
    """Allocator totals (reference malloc_stats_totals_table.rs; jemalloc
    metrics map to the Python allocator + query MemStat totals)."""
    import tracemalloc
    from ..utils.memstat import current_memstat
    ms = current_memstat()
    cur = getattr(ms, "used", 0) if ms is not None else 0
    rows = [("active", int(cur)), ("allocated", int(cur)),
            ("resident", int(cur))]
    if tracemalloc.is_tracing():
        c, p = tracemalloc.get_traced_memory()
        rows.append(("traced_current", int(c)))
        rows.append(("traced_peak", int(p)))
    return _block([
        ("name", String, [r[0] for r in rows]),
        ("value", Int64, [r[1] for r in rows])])


def _sys_notifications(s):
    """CREATE NOTIFICATION integrations (reference notifications_table.rs,
    cloud-control notifications; stored on the meta KV)."""
    rows = [v for _k, v, _s in s.meta.list_prefix("notifications/")]
    return _block([
        ("name", String, [r.get("name", "") for r in rows]),
        ("type", String, [r.get("type", "webhook") for r in rows]),
        ("enabled", Boolean, [bool(r.get("enabled", True)) for r in rows]),
        ("webhook_url", String, [r.get("url", "") for r in rows]),
        ("comment", String, [r.get("comment", "") for r in rows])])


def _sys_notification_history(s):
    rows = [v for _k, v, _s in s.meta.list_prefix("notification_history/")]
    return _block([
        ("name", String, [r.get("name", "") for r in rows]),
        ("status", String, [r.get("status", "") for r in rows]),
        ("message", String, [r.get("message", "") for r in rows]),
        ("created_ts", Float64, [float(r.get("ts", 0)) for r in rows])])


def _sys_tags(s):
    """Object tags (reference tags_table.rs; stored on the meta KV as
    tags/<name> -> {value, objects})."""
    rows = [v for _k, v, _s in s.meta.list_prefix("tags/")]
    return _block([
        ("name", String, [r.get("name", "") for r in rows]),
        ("value", String, [r.get("value", "") for r in rows]),
        ("objects", String, [",".join(r.get("objects", []))
                             for r in rows])])


def _sys_virtual_columns(s):
    """Virtual columns over variant data (reference
    virtual_columns_table.rs); surfaced from table options and from the
    latest snapshot's extracted-path registry (EE auto-extraction)."""
    dbs, tbls, exprs = [], [], []
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            vc = (info.options or {}).get("virtual_columns")
            if not vc:
                try:
                    snap = s.open_table(info).read_snapshot()
                    if snap is not None and snap.virtual_columns:
                        vc = sorted(snap.virtual_columns)
                except Exception:
                    vc = None
            if vc:
                dbs.append(d.name)
                tbls.append(info.name)
                exprs.append(vc if isinstance(vc, str) else ", ".join(vc))
    return _block([
        ("database", String, dbs), ("table", String, tbls),
        ("virtual_columns", String, exprs)])


SYSTEM_TABLES: Dict[str, Callable] = {
    "constraints": _sys_constraints,
    "malloc_stats_totals": _sys_malloc_stats_totals,
    "notifications": _sys_notifications,
    "notification_history": _sys_notification_history,
    "tags": _sys_tags,
    "virtual_columns": _sys_virtual_columns,
    "one": _sys_one,
    "databases": _sys_databases,
    "tables": _sys_tables,
    "columns": _sys_columns,
    "settings": _sys_settings,
    "functions": _sys_functions,
    "metrics": _sys_metrics,
    "query_log": _sys_query_log,
    "indexes": _sys_indexes,
    "caches": _sys_caches,
    "build_options": _sys_build_options,
    "users": _sys_users,
    "roles": _sys_roles,
    "catalogs": _sys_catalogs,
    "engines": _sys_engines,
    "clusters": _sys_clusters,
    "processes": _sys_processes,
    "streams": _sys_streams,
    "tasks": _sys_tasks,
    "views": _sys_views,
    "table_functions": _sys_table_functions,
    "query_cache": _sys_query_cache,
    "statistics": _sys_statistics,
    "locks": _sys_locks,
    "temp_files": _sys_temp_files,
    "configs": _sys_configs,
    "contributors": _sys_contributors,
    "trace_spans": _sys_trace_spans,
    "stages": _sys_stages,
    "sequences": _sys_sequences,
    "temp_tables": _sys_temp_tables,
    "dictionaries": _sys_dictionaries,
    "masking_policies": _sys_masking_policies,
    "workload_groups": _sys_workload_groups,
    "row_access_policies": _sys_row_access_policies,
    "network_policies": _sys_network_policies,
    "password_policies": _sys_password_policies,
    "procedures": _sys_procedures,
    "clustering_history": _sys_clustering_history,
    "zero": _sys_zero,
    "malloc_stats": _sys_malloc_stats,
    "backtrace": _sys_backtrace,
    "credits": _sys_credits,
    "user_functions": _sys_user_functions,
    "query_execution": _sys_query_execution,
}


def system_table_plan(session, name: str):
    fn = SYSTEM_TABLES.get(name.lower())
    if fn is None:
        from ..errors import UnknownTable
        raise UnknownTable(f"unknown system table system.{name}")
    from ..sql.plans import ValuesPlan
    block, fields = fn(session)
    return ValuesPlan(block, fields)
