"""SessionContext: the embedded Python API (bendpy-equivalent) and the
statement interpreter dispatch.

Reference analogs: src/bendpy (SessionContext), interpreters
(src/query/service/src/interpreters/interpreter_*.rs — 150+ files; the
dispatch below covers the statement surface this engine executes).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..catalog import Catalog, TableInfo
from ..catalog.catalog import TableIndexDef
from ..errors import (BadArguments, DatabendError, SemanticError, UnknownTable,
                      UnsupportedFeature)
from ..expression import Column, DataBlock, DataField, TableSchema
from ..expression.evaluator import Evaluator, cast_column, infer_literal_type
from ..meta import MetaStore
from ..settings import Settings
from ..sql import ast as A
from ..sql.parser import parse_sql, parse_statements
from ..storage.fuse import FuseTable
from ..types import Boolean, Float64, Int64, String, parse_type_name
from ..utils.metrics import METRICS

QUERY_LOG_CAPACITY = 10_000

# EXECUTE IMMEDIATE $$ <script> $$ (reference: SQL scripting, src/query/script)
import re as _re

_EXEC_IMMEDIATE_RE = _re.compile(
    r"^\s*EXECUTE\s+IMMEDIATE\s+\$\$(.*)\$\$\s*;?\s*$",
    _re.IGNORECASE | _re.DOTALL)

# CREATE PROCEDURE has a $$-delimited script body the SQL tokenizer never
# sees (reference: procedures carry a LANGUAGE SQL script)
_CREATE_PROC_RE = _re.compile(
    r"^\s*CREATE\s+(?P<replace>OR\s+REPLACE\s+)?PROCEDURE\s+"
    r"(?P<ine>IF\s+NOT\s+EXISTS\s+)?(?P<name>\w+)\s*"
    r"\((?P<args>[^)]*)\)\s*(?:RETURNS\s+[\w()]+\s*)?"
    r"(?:LANGUAGE\s+SQL\s*)?(?:COMMENT\s*=?\s*'[^']*'\s*)?"
    r"AS\s*\$\$(?P<body>.*)\$\$\s*;?\s*$",
    _re.IGNORECASE | _re.DOTALL)


class QueryResult:
    """Result of one statement: a DataBlock + schema + profile info."""

    def __init__(self, block: DataBlock, fields: Optional[List[DataField]] = None,
                 affected_rows: int = 0, profile: Optional[dict] = None):
        self.block = block
        self.fields = fields or [DataField(n, _infer_field(c)) for n, c in block.items()]
        self.affected_rows = affected_rows
        self.profile = profile or {}

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def rows(self) -> List[tuple]:
        cols = [self._render(n, c) for n, c in self.block.items()]
        return [tuple(c[i] for c in cols) for i in range(self.block.num_rows)]

    def to_pydict(self) -> Dict[str, list]:
        return {n: self._render(n, c) for n, c in self.block.items()}

    def _render(self, name: str, col) -> list:
        """Client-facing value conversion: DATE -> datetime.date,
        TIMESTAMP -> datetime.datetime (the wire types bendpy exposes)."""
        import datetime as _dt

        from ..types.datatype import DateType, TimestampType
        vals = col.to_pylist()
        inner = col.dtype.remove_nullable()
        if isinstance(inner, DateType):
            epoch = _dt.date(1970, 1, 1)
            return [None if v is None else epoch + _dt.timedelta(days=int(v))
                    for v in vals]
        if isinstance(inner, TimestampType):
            return [None if v is None else
                    _dt.datetime.fromtimestamp(int(v) / 1e6, _dt.timezone.utc)
                    .replace(tzinfo=None) for v in vals]
        return vals

    def scalar(self):
        rows = self.rows()
        return rows[0][0] if rows else None

    def __len__(self):
        return self.block.num_rows

    def __repr__(self):  # pragma: no cover
        head = " | ".join(self.column_names)
        lines = [head, "-" * len(head)]
        for r in self.rows()[:20]:
            lines.append(" | ".join(str(v) for v in r))
        if self.block.num_rows > 20:
            lines.append(f"... ({self.block.num_rows} rows)")
        return "\n".join(lines)


def _infer_field(col):
    return col.dtype


_SHARED_META: Dict[str, MetaStore] = {}


def _shared_meta(data_root: str) -> MetaStore:
    m = _SHARED_META.get(data_root)
    if m is None:
        m = MetaStore(None)
        _SHARED_META[data_root] = m
    return m


class SessionContext:
    """Embedded engine session: ``SessionContext().sql("SELECT 1")``."""

    def __init__(self, data_root: str = ".databend_tpu",
                 meta_path: Optional[str] = None,
                 meta_endpoint: Optional[str] = None):
        from ..storage.operator import OPERATOR
        OPERATOR.makedirs(data_root)
        self.data_root = data_root
        meta_endpoint = meta_endpoint or os.environ.get(
            "DATABEND_TPU_META_ENDPOINT")
        if meta_endpoint:
            # remote meta service process (reference MetaStore::Remote —
            # query nodes share one raft meta service over the network)
            from ..meta.kv import RemoteMetaStore
            self.meta = RemoteMetaStore(meta_endpoint)
        elif meta_path is None and OPERATOR.is_object_store(data_root):
            # the meta service is separate from object storage in the
            # reference (raft KV, not S3); sessions over the same
            # object-store root share one process-wide embedded KV, the
            # in-process stand-in for the shared meta service
            self.meta = _shared_meta(data_root)
        else:
            if meta_path is None:
                meta_path = os.path.join(data_root, "meta.db")
            self.meta = MetaStore(meta_path)
        self.catalog = Catalog(self.meta)
        self.settings = Settings()
        # meta-persisted global settings survive sessions
        for key, v, _seq in self.meta.list_prefix("settings/"):
            try:
                self.settings.set(key.split("/", 1)[1], v, is_global=True)
            except Exception:
                pass  # stale/unknown persisted setting: ignore
        self.current_database = "default"
        self._tables: Dict[int, FuseTable] = {}
        # in-memory query history (system.query_log; reference history_tables)
        self.query_log: List[dict] = []
        # result_scan: last few SELECT results keyed by query id
        self.variables: Dict[str, object] = {}
        self._result_scan_cache: dict = {}
        self._last_query_ids: List[str] = []
        # (sql, snapshots) -> (ts, QueryResult); active when
        # query_result_cache_ttl_secs > 0
        self._result_cache: Dict[tuple, tuple] = {}
        # PREPARE name FROM '...' registry (session-scoped, like the
        # reference's per-session state)
        self._prepared: Dict[str, object] = {}
        # external-catalog table cache: (catalog, db, table) -> ExternalTable
        self._catalog_tables: Dict[tuple, object] = {}
        from ..users import UserManager
        self.users = UserManager(self.meta)
        self.current_user = self.users.get_user("root")

    def close(self) -> None:
        """Drop session-scoped state (temp tables and their files).
        Reference: temp tables vanish with the session."""
        if getattr(self, "_is_view", False):
            return  # per-request views share the parent's state
        opened = getattr(self, "_temp_open", None) or {}
        for (db, name) in list(opened):
            try:
                self.drop_temp_table(db, name)
            except Exception:
                pass

    def __del__(self):  # best-effort: embedded sessions often just go away
        try:
            self.close()
        except Exception:
            pass

    def authenticate(self, user: str, password: Optional[str] = None) -> None:
        """Switch the session to an authenticated user (HTTP basic auth)."""
        self.current_user = self.users.authenticate(user, password)

    def for_user(self, user) -> "SessionContext":
        """Per-request view of this session bound to ``user``.

        Shares the catalog/meta/settings/table cache with the parent, but
        carries its own ``current_user`` and ``current_database`` so
        concurrent protocol requests can never leak identity into each
        other (reference: per-request session in the HTTP handler).
        """
        import copy
        s = copy.copy(self)
        s.current_user = user
        s._is_view = True  # close() must not tear down the parent's state
        return s

    def check_privilege(self, priv: str, database: str, table: str = "*"):
        # re-resolve from the meta store so grants issued after this
        # session authenticated take effect immediately
        u = self.users.get_user(self.current_user.name) or self.current_user
        self.users.check(u, priv, database, table)

    # ------------------------------------------------------------------- api
    def open_table(self, info: TableInfo) -> FuseTable:
        t = self._tables.get(info.table_id)
        if t is None or t.info.to_dict() != info.to_dict():
            from ..storage.external import EXTERNAL_ENGINES, ExternalTable
            if info.engine.upper() == "ATTACH":
                from ..storage.fuse.table import AttachedTable
                t = AttachedTable(info, self.catalog,
                                  os.path.join(self.data_root, "tables"))
            elif info.engine.upper() in EXTERNAL_ENGINES:
                t = ExternalTable(info, self.catalog,
                                  os.path.join(self.data_root, "tables"))
            else:
                t = FuseTable(info, self.catalog,
                              os.path.join(self.data_root, "tables"))
            self._tables[info.table_id] = t
        return t

    def temp_table(self, db: str, name: str) -> Optional[FuseTable]:
        """Session-scoped temp table, or None (reference: temp tables live
        in the session, shadow the shared catalog, vanish with the session)."""
        opened = getattr(self, "_temp_open", None)
        if not opened:
            return None
        return opened.get((db.lower(), name.lower()))

    def create_temp_table(self, info: TableInfo) -> FuseTable:
        if getattr(self, "_temp_open", None) is None:
            # isolated in-memory catalog: temp snapshots never touch the
            # shared meta service (reference: session-held TableInfo)
            self._temp_catalog = Catalog(MetaStore(None))
            self._temp_open: Dict[tuple, FuseTable] = {}
        info = self._temp_catalog.create_table(info, if_not_exists=False)
        import uuid
        t = FuseTable(info, self._temp_catalog,
                      os.path.join(self.data_root, "temp_tables",
                                   uuid.uuid4().hex[:12]))
        self._temp_open[(info.database.lower(), info.name.lower())] = t
        return t

    def drop_temp_table(self, db: str, name: str) -> bool:
        t = self.temp_table(db, name)
        if t is None:
            return False
        del self._temp_open[(db.lower(), name.lower())]
        import shutil
        shutil.rmtree(t.table_dir, ignore_errors=True)
        return True

    def catalog_table(self, catalog_name: str, db: str, name: str):
        """Resolve `catalog.db.table` through a registered external catalog
        (reference: CatalogManager + iceberg catalog). The catalog's
        LOCATION is a warehouse root laid out as <root>/<db>/<table>/
        (the iceberg filesystem-catalog layout); schemas come from the
        table-format metadata."""
        key = (catalog_name.lower(), db.lower(), name.lower())
        t = self._catalog_tables.get(key)
        if t is not None:
            return t
        meta, _ = self.meta.get(f"catalogs/{catalog_name.lower()}")
        if meta is None:
            from ..errors import UnknownCatalog
            raise UnknownCatalog(f"unknown catalog {catalog_name!r}")
        root = meta["options"].get("location") or meta["options"].get("url")
        loc = os.path.join(root, db, name)
        from ..storage.external import (ExternalTable, iceberg_schema,
                                        paimon_schema)
        if not os.path.isdir(loc):
            from ..errors import UnknownTable
            raise UnknownTable(
                f"unknown table {catalog_name}.{db}.{name!r}")
        fn = iceberg_schema if meta["type"] == "ICEBERG" else paimon_schema
        schema = fn(loc)
        info = TableInfo(-abs(hash(key)) % (1 << 40), db, name, schema,
                         meta["type"], {"location": loc}, [])
        t = ExternalTable(info, self.catalog,
                          os.path.join(self.data_root, "tables"))
        self._catalog_tables[key] = t
        return t

    def catalog_databases(self, catalog_name: str) -> List[str]:
        meta, _ = self.meta.get(f"catalogs/{catalog_name.lower()}")
        if meta is None:
            from ..errors import UnknownCatalog
            raise UnknownCatalog(f"unknown catalog {catalog_name!r}")
        root = meta["options"].get("location") or meta["options"].get("url")
        if not os.path.isdir(root):
            return []
        return sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))

    def catalog_tables(self, catalog_name: str, db: str) -> List[str]:
        meta, _ = self.meta.get(f"catalogs/{catalog_name.lower()}")
        if meta is None:
            from ..errors import UnknownCatalog
            raise UnknownCatalog(f"unknown catalog {catalog_name!r}")
        root = meta["options"].get("location") or meta["options"].get("url")
        p = os.path.join(root, db)
        if not os.path.isdir(p):
            return []
        return sorted(d for d in os.listdir(p)
                      if os.path.isdir(os.path.join(p, d)))

    def table(self, name: str, database: Optional[str] = None) -> FuseTable:
        t = self.temp_table(database or self.current_database, name)
        if t is not None:
            return t
        info = self.catalog.get_table(database or self.current_database, name)
        return self.open_table(info)

    def prepare(self, sql: str):
        """Parse/bind a parameterized statement once; returns a
        ``PreparedStatement`` with ``execute(*params)`` /
        ``execute_batch(param_sets)`` (the batched KNN serving path)."""
        from .prepared import PreparedStatement
        return PreparedStatement(self, sql)

    def sql(self, sql: str) -> QueryResult:
        start = time.time()
        import uuid as _uuid

        # unique across concurrent sessions/threads: KILL QUERY and the
        # process registry key on this id
        entry = {"query_id": f"q{len(self.query_log)}_{int(start * 1e3)}"
                             f"_{_uuid.uuid4().hex[:6]}",
                 "query_text": sql.strip(), "query_kind": "Other",
                 "start": start, "duration_ms": 0.0, "result_rows": 0,
                 "error": None}
        m = _EXEC_IMMEDIATE_RE.match(sql)
        # per-query memory accounting (reference MemStat/LimitMemGuard):
        # buffering operators charge this stat; exceeding max_memory_usage
        # fails the query, never the process
        from ..utils.memstat import MemStat, reset_memstat, set_memstat
        mem_limit = int(self.settings.get("max_memory_usage") or 0)
        # workload-group quotas (reference ee resource_management): the
        # current warehouse's group caps memory/timeout and admits the
        # query through the group's concurrency slot
        _wg_queue = None
        _wg_timeout = 0.0
        from .workload import effective_group, group_queue, parse_bytes
        _wg = effective_group(self)
        if _wg is not None:
            o = _wg.get("options", {})
            if o.get("memory_quota"):
                q = parse_bytes(o["memory_quota"])
                mem_limit = min(mem_limit, q) if mem_limit else q
            _wg_timeout = float(o.get("query_timeout") or 0.0)
            _wg_queue = group_queue(_wg)
        mem = MemStat(mem_limit, entry["query_id"])
        _mem_token = set_memstat(mem)
        _saved_prefix: Dict[str, object] = {}
        if _wg_queue is not None:
            _wg_queue.acquire()
        try:
            if m is not None:
                entry["query_kind"] = "Script"
                from ..script import execute_script_block
                result = execute_script_block(self, m.group(1))
                entry["result_rows"] = len(result)
                METRICS.inc("queries_total")
                return result
            pm = _CREATE_PROC_RE.match(sql)
            if pm is not None:
                entry["query_kind"] = "CreateProcedure"
                result = self._create_procedure(pm)
                METRICS.inc("queries_total")
                return result
            from ..utils.processes import register as _proc_register
            from ..utils.processes import unregister as _proc_unregister
            from ..utils.tracing import reset_query_id, set_query_id, span
            _qid_token = set_query_id(entry["query_id"])
            _proc_register(entry["query_id"], sql.strip(),
                           getattr(self.current_user, "name", "root"))
            try:
                with span("parse"):
                    stmt = parse_sql(sql)
                entry["query_kind"] = type(stmt).__name__.replace("Stmt", "")
                timeout = int(self.settings.get(
                    "max_execute_time_in_seconds") or 0)
                if _wg_timeout:
                    timeout = min(timeout, _wg_timeout) if timeout \
                        else _wg_timeout
                from ..pipeline.executor import set_deadline
                _dl_token = set_deadline(
                    time.monotonic() + timeout if timeout else None)
                # `settings(k=v) <stmt>` applies through result handling
                # (e.g. max_result_rows) — scope it around the whole block
                _prefix = getattr(stmt, "settings_prefix", None)
                if _prefix:
                    for _k, _v in _prefix.items():
                        _saved_prefix[_k] = self.settings.get(_k)
                        self.settings.set(_k, _v)
                    stmt.settings_prefix = None  # inner handler: skip
                try:
                    result = self._execute_statement(stmt)
                finally:
                    set_deadline(None, _dl_token)
            finally:
                _proc_unregister(entry["query_id"])
                reset_query_id(_qid_token)
            max_rows = int(self.settings.get("max_result_rows") or 0)
            if max_rows and isinstance(stmt, A.QueryStmt) \
                    and result.block.num_rows > max_rows:
                result = QueryResult(result.block.slice(0, max_rows),
                                     result.fields, result.affected_rows,
                                     result.profile)

            if isinstance(stmt, A.QueryStmt):
                # result_scan(last_query_id()) support (reference:
                # result_scan table function + result cache)
                self._result_scan_cache[entry["query_id"]] = \
                    (result.block, result.fields)
                self._last_query_ids.append(entry["query_id"])
                while len(self._result_scan_cache) > 8:
                    self._result_scan_cache.pop(
                        next(iter(self._result_scan_cache)))
                del self._last_query_ids[:-64]
            entry["result_rows"] = len(result)
            METRICS.inc("queries_total")
            return result
        except DatabendError as e:
            entry["error"] = str(e)
            METRICS.inc("queries_failed")
            raise
        finally:
            for _k, _v in _saved_prefix.items():
                try:
                    self.settings.set(_k, _v)
                except Exception:
                    pass
            if _wg_queue is not None:
                _wg_queue.release()
            reset_memstat(_mem_token)
            entry["peak_memory_bytes"] = mem.peak
            entry["duration_ms"] = (time.time() - start) * 1e3
            self.query_log.append(entry)
            if len(self.query_log) > QUERY_LOG_CAPACITY:
                del self.query_log[:len(self.query_log) - QUERY_LOG_CAPACITY]
            METRICS.observe("query_seconds", time.time() - start)
            try:
                from ..utils.otlp import export_query_spans
                export_query_spans(self, entry["query_id"])
            except Exception:
                pass  # export must never fail the query

    def execute_script(self, sql: str) -> List[QueryResult]:
        return [self._execute_statement(s) for s in parse_statements(sql)]

    def insert_block(self, table_name: str, block: DataBlock,
                     database: Optional[str] = None) -> int:
        """Bulk ingestion path (arrow/numpy-friendly, no SQL round trip)."""
        t = self.table(table_name, database)
        t.append(block)
        return block.num_rows

    @property
    def tasks(self):
        if getattr(self, "_tasks", None) is None:
            from .tasks import TaskManager
            self._tasks = TaskManager(self)
        return self._tasks

    @property
    def stages(self):
        if getattr(self, "_stages", None) is None:
            from ..storage.stage import StageManager
            self._stages = StageManager(self.meta, self.data_root)
        return self._stages

    @property
    def sequences(self):
        if getattr(self, "_sequences", None) is None:
            from .sequences import SequenceManager
            self._sequences = SequenceManager(self.meta)
        return self._sequences

    @property
    def policies(self):
        if getattr(self, "_policies", None) is None:
            from .policies import PolicyManager
            self._policies = PolicyManager(self.meta)
        return self._policies

    @property
    def dictionaries(self):
        if getattr(self, "_dictionaries", None) is None:
            from .dictionaries import DictionaryManager
            self._dictionaries = DictionaryManager(self)
        return self._dictionaries

    @property
    def streams(self):
        if getattr(self, "_streams", None) is None:
            from ..storage.stream import StreamManager
            self._streams = StreamManager(self)
        return self._streams

    @property
    def udfs(self) -> Dict[str, dict]:
        if getattr(self, "_udf_cache", None) is None:
            self._udf_cache = {k.split("/", 1)[1]: v for k, v, _
                               in self.meta.list_prefix("udfs/")}
            # external UDF-server functions resolve through the scalar
            # registry; (re-)register what this meta store defines
            from ..service.udf_client import register_external_udf
            for name, meta in self._udf_cache.items():
                if isinstance(meta, dict) and meta.get("kind") == "external":
                    try:
                        register_external_udf(name, meta)
                    except Exception:
                        pass  # bad persisted definition: surfaced at call
        return self._udf_cache

    def invalidate_udfs(self):
        self._udf_cache = None

    # -------------------------------------------------------- result cache
    def _result_cache_key(self, stmt: A.QueryStmt) -> Optional[tuple]:
        """(sql-repr, snapshot fingerprints) — only cacheable when every
        referenced table's head snapshot is part of the key (reference:
        query result cache keyed on snapshot ids)."""
        ttl = self.settings.get("query_result_cache_ttl_secs")
        if not ttl:
            return None
        # never cache non-deterministic queries (reference result cache
        # skips them too)
        sql_l = repr(stmt.query).lower()
        for fn in ("now", "rand", "random", "uuid", "current_timestamp",
                   "today", "yesterday", "tomorrow"):
            if fn + "(" in sql_l or f"'{fn}'" in sql_l:
                return None
        snaps = []
        for d in self.catalog.list_databases():
            for info in self.catalog.list_tables(d.name):
                loc, seq = self.catalog.get_snapshot_location(info.table_id)
                snaps.append((info.table_id, loc, seq))
        # current_database resolves unqualified names; it must be in the key
        return (repr(stmt.query), self.current_database, tuple(sorted(snaps)))

    def _create_procedure(self, pm) -> QueryResult:
        """CREATE [OR REPLACE] PROCEDURE p(args) AS $$ script $$
        (reference: procedure interpreters + system.procedures)."""
        self.check_privilege("SUPER", "*")
        name = pm.group("name")
        args = []
        for part in pm.group("args").split(","):
            part = part.strip()
            if part:
                bits = part.split()
                args.append((bits[0], " ".join(bits[1:]) or "VARCHAR"))
        key = f"procedures/{name.lower()}"
        got, _seq = self.meta.get(key)
        if got is not None and not pm.group("replace"):
            if pm.group("ine"):
                return QueryResult(DataBlock.empty(), [], 0)
            raise BadArguments(f"procedure {name!r} already exists")
        self.meta.upsert(key, {"name": name, "args": [list(a) for a in args],
                               "body": pm.group("body").strip()})
        return QueryResult(DataBlock.empty(), [], 0)

    # ----------------------------------------------------------- dispatching
    def _execute_statement(self, stmt: A.Statement) -> QueryResult:
        from ..utils.current import reset_session, set_session
        token = set_session(self)
        # `settings(k=v) <stmt>`: one-statement settings scope (reference
        # sqllogictests prefix syntax)
        prefix = getattr(stmt, "settings_prefix", None)
        saved = {}
        if prefix:
            for k, v in prefix.items():
                saved[k] = self.settings.get(k)
                self.settings.set(k, v)
        try:
            return self._execute_statement_inner(stmt)
        finally:
            if prefix:
                for k, v in saved.items():
                    try:
                        self.settings.set(k, v)
                    except Exception:
                        pass
            reset_session(token)

    def _execute_statement_inner(self, stmt: A.Statement) -> QueryResult:
        from ..pipeline.executor import execute_plan
        from ..sql.binder import Binder
        if self.udfs and not isinstance(stmt, (A.CreateFunction, A.DropFunction)):
            from ..sql.udf import expand_udfs
            stmt = expand_udfs(stmt, self.udfs)
        if isinstance(stmt, A.QueryStmt):
            key = self._result_cache_key(stmt)
            if key is not None:
                cached = self._result_cache.get(key)
                if cached is not None and (time.time() - cached[0]
                                           < self.settings.get(
                                               "query_result_cache_ttl_secs")):
                    METRICS.inc("result_cache_hits")
                    return cached[1]
        if isinstance(stmt, A.QueryStmt):
            from ..sql.optimizer import optimize
            from ..utils.tracing import span
            with span("bind"):
                plan = Binder(self).bind_query(stmt.query)
            with span("optimize"):
                plan = optimize(plan, self)
            with span("execute"):
                block = execute_plan(plan)
            if getattr(stmt.query, "ignore_result", False):
                block = block.filter(
                    __import__("numpy").zeros(block.num_rows, bool))
            result = QueryResult(block, plan.output_fields())
            key = self._result_cache_key(stmt)
            if key is not None:
                self._result_cache[key] = (time.time(), result)
                if len(self._result_cache) > 256:
                    oldest = min(self._result_cache,
                                 key=lambda k: self._result_cache[k][0])
                    del self._result_cache[oldest]
            return result
        if isinstance(stmt, A.ExplainStmt):
            return self._explain(stmt)
        handler = _STATEMENTS.get(type(stmt))
        if handler is None:
            raise UnsupportedFeature(f"unsupported statement {type(stmt).__name__}")
        return handler(self, stmt)

    def _explain(self, stmt: A.ExplainStmt) -> QueryResult:
        from ..pipeline.executor import execute_plan
        from ..sql.binder import Binder
        if stmt.kind == "AST":
            # reference EXPLAIN AST/SYNTAX: the parsed tree, one node/line
            lines = _format_ast(stmt.inner).split("\n")
            col = Column.from_pylist(lines, String)
            return QueryResult(DataBlock(["explain"], [col]),
                               [DataField("explain", String)])
        if stmt.kind == "PERF":
            # reference EXPLAIN PERF: run the statement under a sampling
            # profiler and return ONE HTML row embedding a flamegraph
            # (interpreter_explain_perf.rs:85-122, query_perf.rs:72-115)
            from ..utils.perf import (profile_call, render_flamegraph_svg,
                                      render_perf_html)
            _, prof = profile_call(
                lambda: self._execute_statement_inner(stmt.inner))
            svg = render_flamegraph_svg(prof.folded)
            import os
            import socket
            node_id = f"{socket.gethostname()}-{os.getpid()}"
            page = render_perf_html([(node_id, svg)])
            col = Column.from_pylist([page], String)
            return QueryResult(DataBlock(["result"], [col], 1),
                               [DataField("result", String)])
        if not isinstance(stmt.inner, A.QueryStmt):
            raise SemanticError("EXPLAIN supports queries only")
        from ..sql.optimizer import optimize
        plan = Binder(self).bind_query(stmt.inner.query)
        if stmt.kind != "RAW":  # RAW = the plan before optimization
            plan = optimize(plan, self)
        if stmt.kind == "PIPELINE":
            # executor view: one line per operator with its executor fn
            from ..pipeline.executor import _DISPATCH
            lines = []

            def walk(p, d=0):
                fn = _DISPATCH.get(type(p))
                lines.append("  " * d + type(p).__name__ + " -> "
                             + (fn.__name__ if fn else "?"))
                for c in p.children():
                    walk(c, d + 1)
            walk(plan)
        else:
            lines = plan.explain().split("\n")
        if stmt.analyze:
            t0 = time.time()
            block = execute_plan(plan)
            elapsed = time.time() - t0
            # re-render the tree with per-operator profiles (reference
            # EXPLAIN ANALYZE / PlanProfile)
            lines = _explain_with_profile(plan).split("\n")
            lines.append(f"-- executed in {elapsed*1000:.1f} ms, {block.num_rows} rows")
            for line in _collect_pruning_stats(plan):
                lines.append("-- " + line)
        col = Column.from_pylist(lines, String)
        return QueryResult(DataBlock(["explain"], [col]), [DataField("explain", String)])


def _format_ast(node, depth: int = 0, name: str = "") -> str:
    """Indented AST dump (reference EXPLAIN AST formatting)."""
    import dataclasses
    pad = "  " * depth
    label = (name + ": " if name else "") + type(node).__name__
    if not dataclasses.is_dataclass(node):
        return pad + label + f" = {node!r}"
    lines = [pad + label]
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if v is None or v == [] or v == {} or v is False:
            continue
        if dataclasses.is_dataclass(v):
            lines.append(_format_ast(v, depth + 1, f.name))
        elif isinstance(v, (list, tuple)) and v \
                and any(dataclasses.is_dataclass(x) for x in v):
            lines.append(pad + "  " + f.name + ":")
            for x in v:
                lines.append(_format_ast(x, depth + 2)
                             if dataclasses.is_dataclass(x)
                             else "  " * (depth + 2) + repr(x))
        else:
            lines.append(pad + "  " + f.name + f" = {v!r}")
    return "\n".join(lines)


def _explain_with_profile(plan, indent: int = 0) -> str:
    pad = "  " * indent
    prof = getattr(plan, "_profile", None) or plan.__dict__.get("_profile")
    line = pad + plan._explain_line()
    if prof:
        child_ms = sum((c.__dict__.get("_profile") or {}).get("ms", 0.0)
                       for c in plan.children())
        own = max(prof["ms"] - child_ms, 0.0)
        line += (f"  [rows: {prof['rows']}, blocks: {prof['blocks']}, "
                 f"total: {prof['ms']:.2f} ms, self: {own:.2f} ms]")
    parts = [line] + [_explain_with_profile(c, indent + 1)
                      for c in plan.children()]
    return "\n".join(parts)


def _collect_pruning_stats(plan) -> List[str]:
    from ..sql.plans import Scan
    out = []
    def visit(p):
        if isinstance(p, Scan) and getattr(p, "pruning_stats", None) is not None:
            s = p.pruning_stats
            out.append(f"pruning: segments {s.segments_before}->{s.segments_after}, "
                       f"blocks {s.blocks_before}->{s.blocks_after} "
                       f"(range {s.blocks_range_after}, bloom {s.blocks_bloom_after}, "
                       f"topn {s.blocks_topn_after}, "
                       f"vector_stats {s.blocks_vector_stats_after})")
        for c in p.children():
            visit(c)
    visit(plan)
    return out


# ---------------------------------------------------------------- statements
def _ok(affected: int = 0) -> QueryResult:
    return QueryResult(DataBlock.empty(), [], affected)


def _stmt_create_database(s: SessionContext, st: A.CreateDatabase):
    s.catalog.create_database(st.name, st.if_not_exists)
    return _ok()


def _stmt_drop_database(s: SessionContext, st: A.DropDatabase):
    s.catalog.drop_database(st.name, st.if_exists)
    return _ok()


def _stmt_use(s: SessionContext, st: A.UseDatabase):
    if s.catalog.get_database(st.name) is None:
        from ..errors import UnknownDatabase
        raise UnknownDatabase(f"unknown database {st.name!r}")
    s.current_database = st.name
    return _ok()


def _stmt_create_table(s: SessionContext, st: A.CreateTable):
    s.check_privilege("CREATE", st.database or s.current_database)
    if st.or_replace and not st.temporary:
        # CREATE OR REPLACE drops the existing table (and its data) first
        db_ = st.database or s.current_database
        if not s.drop_temp_table(db_, st.name):
            info_old = s.catalog.drop_table(db_, st.name, if_exists=True)
            if info_old is not None:
                s._tables.pop(info_old.table_id, None)

    like = st.options.pop("like", None)
    if like is not None:
        # CREATE TABLE ... LIKE src: copy schema/options, no data
        src_db, _, src = like.partition(".")
        src_info = s.catalog.get_table(src_db or s.current_database, src)
        st.columns = []
        st.options.update({k: v for k, v in src_info.options.items()
                           if k != "like"})
        import copy as _copy
        fields = [_copy.deepcopy(f) for f in src_info.schema.fields]
        db = st.database or s.current_database
        info = TableInfo(0, db, st.name, TableSchema(fields), st.engine,
                         dict(st.options), list(src_info.cluster_by))
        if st.temporary:
            s.create_temp_table(info)
        else:
            s.catalog.create_table(info, st.if_not_exists)
        return _ok()

    fields = []
    computed_opts = {}
    for c in st.columns:
        dtype = parse_type_name(c.type_name)
        if c.nullable and not dtype.is_nullable():
            dtype = dtype.wrap_nullable()
        default = c.default.value if isinstance(c.default, A.Literal) else None
        fields.append(DataField(c.name, dtype, default))
        if c.computed is not None:
            expr_sql, kind = c.computed
            computed_opts[f"computed:{c.name.lower()}"] = f"{kind}:{expr_sql}"
    if computed_opts:
        from ..license import check_feature
        check_feature(s, "computed_column")
        st.options.update(computed_opts)
    db = st.database or s.current_database
    cluster_by = [c.name for c in st.cluster_by if isinstance(c, A.ColumnRef)]
    if not fields and st.engine.upper() in ("ICEBERG", "PAIMON"):
        # schema comes from the table-format metadata (reference
        # storages/iceberg, storages paimon engine)
        from ..storage.external import iceberg_schema, paimon_schema
        loc = st.options.get("location")
        if not loc:
            raise BadArguments(
                f"ENGINE={st.engine.upper()} requires LOCATION='path'")
        fn = iceberg_schema if st.engine.upper() == "ICEBERG" \
            else paimon_schema
        fields = list(fn(loc).fields)
    if st.as_query is not None and not fields:
        from ..sql.binder import Binder
        plan = Binder(s).bind_query(st.as_query)
        fields = [DataField(f.name, f.dtype) for f in plan.output_fields()]
    info = TableInfo(0, db, st.name, TableSchema(fields), st.engine,
                     dict(st.options), cluster_by)
    if st.temporary:
        if st.or_replace:
            s.drop_temp_table(db, st.name)
        if s.temp_table(db, st.name) is not None:
            if st.if_not_exists:
                return _ok()
            from ..errors import TableAlreadyExists
            raise TableAlreadyExists(f"temp table {st.name!r} already exists")
        t = s.create_temp_table(info)
        if st.as_query is not None:
            from ..pipeline.executor import execute_plan
            from ..sql.binder import Binder
            block = execute_plan(Binder(s).bind_query(st.as_query))
            if block.num_rows:
                t.append(block)
        return _ok()
    inline = list(getattr(st, "inline_indexes", []) or [])
    for itype, iname, icols, iopts, _sync in inline:
        _validate_index_options(itype, iopts)
    # vector cluster keys need exactly one single-distance vector index
    # (reference: TransformVectorCluster requires the quantization the
    # index defines; errors mirrored from 09_0000_vector_index_base.test)
    from ..types import VectorType as _VT
    for ck in cluster_by:
        f = next((f for f in fields if f.name.lower() == ck.lower()), None)
        if f is None or not isinstance(f.dtype.remove_nullable(), _VT):
            continue
        covering = [(n, o) for t_, n, cols_, o, _s in inline
                    if t_ == "VECTOR" and ck.lower() in
                    [c.lower() for c in cols_]]
        if not covering:
            raise SemanticError(
                f"Vector cluster key `{ck}` requires a vector index with "
                f"distance option")
        distances = [m.strip() for _, o in covering
                     for m in o.get("distance", "").split(",") if m.strip()]
        if len(distances) != 1:
            raise SemanticError(
                f"Vector cluster key `{ck}` has multiple vector index "
                f"distance types")
    info = s.catalog.create_table(info, st.if_not_exists)
    for itype, iname, icols, iopts, sync in inline:
        idx = TableIndexDef(iname, itype, icols, dict(iopts), sync)
        info = s.catalog.create_index(info.database, info.name, idx, False)
    if st.as_query is not None:
        from ..pipeline.executor import execute_plan
        from ..sql.binder import Binder
        plan = Binder(s).bind_query(st.as_query)
        block = execute_plan(plan)
        if block.num_rows:
            s.open_table(info).append(block)
    return _ok()


def _stmt_drop_table(s: SessionContext, st: A.DropTable):
    db = st.database or s.current_database
    if s.drop_temp_table(db, st.name):  # session-private: no RBAC gate
        return _ok()
    s.check_privilege("DROP", st.database or s.current_database, st.name)
    info = s.catalog.drop_table(db, st.name, st.if_exists)
    if info is not None and st.all_:
        from ..storage.operator import OPERATOR
        d = os.path.join(s.data_root, "tables", str(info.table_id))
        if OPERATOR.is_object_store(d):
            for key in OPERATOR.list(d):
                OPERATOR.delete(key)
        else:
            import shutil
            shutil.rmtree(d, ignore_errors=True)
    return _ok()


def _stmt_truncate(s: SessionContext, st: A.TruncateTable):
    s.check_privilege("DELETE", st.database or s.current_database, st.name)
    s.table(st.name, st.database).truncate()
    return _ok()


def _stmt_rename(s: SessionContext, st: A.RenameTable):
    db = st.database or s.current_database
    s.catalog.rename_table(db, st.name, st.new_name)
    return _ok()


def _stmt_flashback(s: SessionContext, st: A.FlashbackTable):
    s.check_privilege("ALTER", st.database or s.current_database, st.name)
    t = s.table(st.name, st.database)
    t.flashback(st.point)
    return _ok()


def _copy_sources(src: str, pattern: Optional[str]) -> List[str]:
    import fnmatch
    import glob
    if os.path.isdir(src):
        names = sorted(os.listdir(src))
        if pattern:
            names = [n for n in names if fnmatch.fnmatch(n, pattern)]
        return [os.path.join(src, n) for n in names if os.path.isfile(os.path.join(src, n))]
    hits = sorted(glob.glob(src))
    if not hits:
        raise BadArguments(f"COPY source matches no files: {src!r}")
    return hits


def _stmt_show_create(s: SessionContext, st: A.ShowCreateTable):
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.name)
    cols = []
    for f in info.schema.fields:
        line = f"  {f.name} {f.dtype.sql_name()}"
        if f.default is not None:
            line += f" DEFAULT {f.default!r}"
        cols.append(line)
    ddl = f"CREATE TABLE {info.name} (\n" + ",\n".join(cols) + "\n)"
    if info.cluster_by:
        ddl += f" CLUSTER BY ({', '.join(info.cluster_by)})"
    opts = {k: v for k, v in info.options.items()}
    if opts and not s.settings.get("hide_options_in_show_create_table"):
        ddl += " " + " ".join(f"{k.upper()}='{v}'" for k, v in sorted(opts.items()))
    for idx in info.indexes.values():
        o = " ".join(f"{k}='{v}'" for k, v in sorted(idx.options.items()))
        ddl += (f";\nCREATE {idx.index_type} INDEX {idx.name} ON "
                f"{info.name}({', '.join(idx.columns)})" + (" " + o if o else ""))
    block = DataBlock(["Table", "Create Table"],
                      [Column.from_pylist([info.name], String),
                       Column.from_pylist([ddl], String)], 1)
    return QueryResult(block, [DataField("Table", String),
                               DataField("Create Table", String)])


def _stmt_undrop(s: SessionContext, st: A.UndropTable):
    db = st.database or s.current_database
    s.catalog.undrop_table(db, st.name)
    return _ok()


def _stmt_merge(s: SessionContext, st: A.MergeInto):
    from .merge import execute_merge
    upd, dele, ins = execute_merge(s, st)
    return _ok(upd + dele + ins)


def _stmt_create_task(s: SessionContext, st: A.CreateTask):
    if st.warehouse:
        # task/warehouse affinity: the named warehouse must exist once any
        # warehouse objects are defined (reference: tasks schedule onto a
        # warehouse via cloud control)
        got, _seq = s.meta.get(f"warehouses/{st.warehouse.lower()}")
        has_any = any(True for _ in s.meta.list_prefix("warehouses/"))
        if got is None and has_any:
            raise BadArguments(f"unknown warehouse {st.warehouse!r}")
    if st.or_replace:
        s.tasks.drop(st.name, if_exists=True)
    s.tasks.create(st.name, st.schedule_secs, st.sql_text, st.if_not_exists,
                   warehouse=st.warehouse, cron=st.cron, comment=st.comment,
                   after=st.after, when=st.when,
                   suspend_after_failures=st.suspend_after_failures)
    return _ok()


def _stmt_drop_task(s: SessionContext, st: A.DropTask):
    s.tasks.drop(st.name, st.if_exists)
    return _ok()


def _stmt_alter_task(s: SessionContext, st: A.AlterTask):
    s.tasks.get(st.name)  # raises on unknown
    s.tasks.set_state(st.name, "STARTED" if st.action == "RESUME" else "SUSPENDED")
    if st.action == "RESUME":
        s.tasks.start_scheduler()
    return _ok()


def _stmt_execute_task(s: SessionContext, st: A.ExecuteTask):
    s.tasks.execute(st.name)
    return _ok()


def _stmt_create_view(s: SessionContext, st: A.CreateView):
    db = st.database or s.current_database
    key = f"views/{db.lower()}/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is not None and not st.or_replace:
        if st.if_not_exists:
            return _ok()
        raise SemanticError(f"view {st.name!r} already exists")
    s.meta.upsert(key, {"query_text": st.query_text})
    return _ok()


def _stmt_drop_view(s: SessionContext, st: A.DropView):
    db = st.database or s.current_database
    key = f"views/{db.lower()}/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is None:
        if st.if_exists:
            return _ok()
        raise SemanticError(f"unknown view {st.name!r}")
    s.meta.delete(key)
    return _ok()


def _stmt_create_stream(s: SessionContext, st: A.CreateStream):
    db = st.database or s.current_database
    tdb = st.table_database or s.current_database
    s.streams.create(db, st.name, tdb, st.table, st.if_not_exists)
    return _ok()


def _stmt_drop_stream(s: SessionContext, st: A.DropStream):
    db = st.database or s.current_database
    s.streams.drop(db, st.name, st.if_exists)
    return _ok()


def _stmt_create_function(s: SessionContext, st: A.CreateFunction):
    key = f"udfs/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is not None and not st.or_replace:
        if st.if_not_exists:
            return _ok()
        raise SemanticError(f"function {st.name!r} already exists")
    from ..expression.functions import registry
    from ..expression.functions.aggregates import is_aggregate_function
    from ..service.udf_client import _REGISTERED
    if (registry.contains(st.name.lower())
            and st.name.lower() not in _REGISTERED) \
            or is_aggregate_function(st.name.lower()):
        raise SemanticError(f"cannot shadow built-in function {st.name!r}")
    if st.address is not None:
        # external UDF-server function (reference udf_server suites)
        from ..service.udf_client import register_external_udf
        meta = {"kind": "external", "arg_types": st.arg_types or [],
                "return_type": st.return_type, "language": st.language,
                "handler": st.handler, "address": st.address}
        s.meta.upsert(key, meta)
        register_external_udf(st.name, meta)
    else:
        s.meta.upsert(key, {"params": [p.lower() for p in st.params],
                            "body_text": st.body_text})
    s.invalidate_udfs()
    return _ok()


def _stmt_drop_function(s: SessionContext, st: A.DropFunction):
    key = f"udfs/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is None:
        if st.if_exists:
            return _ok()
        raise SemanticError(f"unknown function {st.name!r}")
    if isinstance(cur, dict) and cur.get("kind") == "external":
        from ..service.udf_client import unregister_external_udf
        unregister_external_udf(st.name)
    s.meta.delete(key)
    s.invalidate_udfs()
    return _ok()


def _stmt_create_user(s: SessionContext, st: A.CreateUser):
    s.check_privilege("SUPER", "*")
    s.users.create_user(st.name, st.password, st.if_not_exists)
    return _ok()


def _stmt_drop_user(s: SessionContext, st: A.DropUser):
    s.check_privilege("SUPER", "*")
    s.users.drop_user(st.name, st.if_exists)
    return _ok()


def _stmt_create_role(s: SessionContext, st: A.CreateRole):
    s.check_privilege("SUPER", "*")
    s.users.create_role(st.name, st.if_not_exists)
    return _ok()


def _stmt_drop_role(s: SessionContext, st: A.DropRole):
    s.check_privilege("SUPER", "*")
    s.users.drop_role(st.name, st.if_exists)
    return _ok()


def _stmt_grant_role(s: SessionContext, st: A.GrantRole):
    s.check_privilege("SUPER", "*")
    if st.is_grant:
        s.users.grant_role(st.role, st.user)
    else:
        u = s.users.get_user(st.user)
        if u is not None and st.role.lower() in u.roles:
            u.roles.remove(st.role.lower())
            s.users.meta.upsert(f"users/{u.name}", u.to_dict())
    return _ok()


def _stmt_grant_privileges(s: SessionContext, st: A.GrantPrivileges):
    s.check_privilege("SUPER", "*")
    db = st.database if st.database is not None else (
        "*" if st.table == "*" else s.current_database)
    privs = {p.upper() for p in st.privileges}
    if st.is_grant:
        s.users.grant(privs, db, st.table, to_role=st.role, to_user=st.user)
    else:
        s.users.revoke(privs, db, st.table, from_role=st.role, from_user=st.user)
    return _ok()


def _stmt_show_grants(s: SessionContext, st: A.ShowGrants):
    if st.user and st.user.lower() != s.current_user.name.lower():
        s.check_privilege("SUPER", "*")
    name = st.user or s.current_user.name
    u = s.users.get_user(name)
    if u is None:
        from ..users import UnknownUser
        raise UnknownUser(f"unknown user {name!r}")
    lines = []
    for g in s.users.effective_grants(u):
        lines.append(f"GRANT {','.join(sorted(g.privileges))} ON "
                     f"{g.database}.{g.table} TO {u.name}")
    col = Column.from_pylist(lines, String)
    return QueryResult(DataBlock(["grants"], [col]), [DataField("grants", String)])


def _stmt_copy_into_table(s: SessionContext, st: A.CopyIntoTable):
    """COPY INTO t FROM 'path'|@stage — bulk load (reference: stage COPY
    path, src/query/storages/stage + formats field decoders). Stage loads
    track already-copied files per table (reference copied-files dedup in
    the COPY interpreter); FORCE=TRUE reloads them."""
    from ..formats import FileFormatOptions, detect_format, read_file
    s.check_privilege("INSERT", st.database or s.current_database, st.table)
    t = s.table(st.table, st.database)
    opts = None
    if st.file_format:
        opts = FileFormatOptions.from_dict(st.file_format)
    loaded = 0
    if st.src.startswith("@"):
        info, _rel = s.stages.resolve(st.src)
        if not st.file_format and info.file_format:
            opts = FileFormatOptions.from_dict(info.file_format)
        sources = s.stages.source_files(st.src, st.pattern, st.files)
        key = f"copied_files/{t.info.table_id}"
        got, _seq = s.meta.get(key)
        copied = dict(got) if got is not None else {}
        scratch = os.path.join(s.data_root, "scratch")
        for name, skey in sources:
            from ..storage.operator import OPERATOR
            size = OPERATOR.size(skey)
            mark = f"{info.name}:{name}"
            if not st.force and copied.get(mark) == size:
                continue
            local = s.stages.materialize(info, skey, scratch)
            o = opts or FileFormatOptions(type=detect_format(name))
            block = read_file(local, t.schema, o)
            if block.num_rows:
                t.append(block)
                loaded += block.num_rows
            copied[mark] = size
            if local != skey:
                os.unlink(local)
        s.meta.upsert(key, copied)
    else:
        for path in _copy_sources(st.src, st.pattern):
            o = opts or FileFormatOptions(type=detect_format(path))
            block = read_file(path, t.schema, o)
            if block.num_rows:
                t.append(block)
                loaded += block.num_rows
    res = _ok(loaded)
    METRICS.inc("copy_rows_loaded", loaded)
    return res


def _stmt_copy_into_location(s: SessionContext, st: A.CopyIntoLocation):
    from ..formats import FileFormatOptions, detect_format, write_file
    from ..pipeline.executor import execute_plan
    from ..sql.binder import Binder
    if st.query is not None:
        plan = Binder(s).bind_query(st.query)
        block = execute_plan(plan)
    else:
        t = s.table(st.table, st.database)
        from ..catalog.pushdown import PushDownInfo
        from ..sql.plans import Scan
        block = execute_plan(Scan(t, PushDownInfo()))
    dst = st.dst
    fmt = dict(st.file_format)
    if dst.startswith("@"):
        info, rel = s.stages.resolve(dst)
        if not fmt and info.file_format:
            fmt = dict(info.file_format)
        if not rel or rel.endswith("/"):
            rel = (rel or "") + "data_0.csv"
        from ..storage.stage import _join
        dst = _join(info.url, rel)
        from ..storage.operator import OPERATOR
        if not OPERATOR.is_object_store(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
        opts = (FileFormatOptions.from_dict(fmt) if fmt
                else FileFormatOptions(type=detect_format(dst)))
        if OPERATOR.is_object_store(dst):
            # encode locally, upload through the operator
            import tempfile
            with tempfile.TemporaryDirectory() as td:
                local = os.path.join(td, os.path.basename(dst))
                n = write_file(local, block, opts)
                with open(local, "rb") as f:
                    OPERATOR.write_bytes(dst, f.read())
            return _ok(n)
        return _ok(write_file(dst, block, opts))
    opts = (FileFormatOptions.from_dict(fmt) if fmt
            else FileFormatOptions(type=detect_format(dst)))
    n = write_file(dst, block, opts)
    return _ok(n)


def _stmt_add_column(s: SessionContext, st: A.AddColumn):
    """ALTER TABLE ADD COLUMN — existing blocks backfill the default/NULL
    at read (reference: schema evolution via column ids + defaults)."""
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.table)
    c = st.column
    if info.schema.has_field(c.name):
        if st.if_not_exists:
            return _ok()
        raise SemanticError(f"column {c.name!r} already exists")
    dtype = parse_type_name(c.type_name)
    if c.nullable and not dtype.is_nullable():
        dtype = dtype.wrap_nullable()
    default = c.default.value if isinstance(c.default, A.Literal) else None
    f = DataField(c.name, dtype, default)
    f.column_id = info.schema.next_column_id
    info.schema.fields.append(f)
    info.schema.next_column_id += 1
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_drop_column(s: SessionContext, st: A.DropColumn):
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.table)
    if not info.schema.has_field(st.column):
        if st.if_exists:
            return _ok()
        from ..errors import UnknownColumn
        raise UnknownColumn(f"unknown column {st.column!r}")
    if len(info.schema.fields) == 1:
        raise SemanticError("cannot drop the last column")
    idx = info.schema.index_of(st.column)
    dropped = info.schema.fields.pop(idx)
    # detach any masking policy bound to the dropped column
    info.options.pop(f"mask:{dropped.name.lower()}", None)
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_rename_column(s: SessionContext, st: A.RenameColumn):
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.table)
    if info.schema.has_field(st.new):
        raise SemanticError(f"column {st.new!r} already exists")
    f = info.schema.field(st.old)
    f.prior_names.append(f.name)  # old blocks resolve through this
    mask = info.options.pop(f"mask:{f.name.lower()}", None)
    f.name = st.new
    if mask is not None:
        info.options[f"mask:{st.new.lower()}"] = mask
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_create_masking_policy(s: SessionContext, st: A.CreateMaskingPolicy):
    from ..license import check_feature
    check_feature(s, "data_mask")
    s.check_privilege("SUPER", "*")
    from .policies import MaskingPolicy
    s.policies.create_masking(
        MaskingPolicy(st.name, st.arg_name, st.arg_type, st.ret_type,
                      st.body_sql, st.comment),
        st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_masking_policy(s: SessionContext, st: A.DropMaskingPolicy):
    s.check_privilege("SUPER", "*")
    s.policies.drop_masking(st.name, st.if_exists)
    return _ok()


def _stmt_desc_masking_policy(s: SessionContext, st: A.DescMaskingPolicy):
    p = s.policies.get_masking(st.name)
    names = ["name", "signature", "return_type", "body", "comment"]
    vals = [p.name, f"({p.arg_name} {p.arg_type})", p.ret_type, p.body,
            p.comment]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_create_row_access_policy(s: SessionContext,
                                   st: A.CreateRowAccessPolicy):
    from ..license import check_feature
    check_feature(s, "row_access_policy")
    s.check_privilege("SUPER", "*")
    from .policies import RowAccessPolicy
    s.policies.create_row_access(
        RowAccessPolicy(st.name, list(st.args), st.body_sql, st.comment),
        st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_row_access_policy(s: SessionContext, st: A.DropRowAccessPolicy):
    s.check_privilege("SUPER", "*")
    s.policies.drop_row_access(st.name, st.if_exists)
    return _ok()


def _stmt_set_column_masking_policy(s: SessionContext,
                                    st: A.SetColumnMaskingPolicy):
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.table)
    f = info.schema.field(st.column)  # validates the column exists
    key = f"mask:{f.name.lower()}"
    if st.policy is None:
        info.options.pop(key, None)
    else:
        from ..license import check_feature
        check_feature(s, "data_mask")
        s.policies.get_masking(st.policy)  # validates the policy exists
        info.options[key] = st.policy
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_set_table_row_access_policy(s: SessionContext,
                                      st: A.SetTableRowAccessPolicy):
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    info = s.catalog.get_table(db, st.table)
    if st.drop:
        info.options.pop("row_access", None)
    else:
        from ..license import check_feature
        check_feature(s, "row_access_policy")
        policy = s.policies.get_row_access(st.policy)
        if len(st.columns) != len(policy.args):
            raise SemanticError(
                f"row access policy {st.policy!r} expects "
                f"{len(policy.args)} columns")
        for c in st.columns:
            info.schema.field(c)  # validates
        info.options["row_access"] = f"{st.policy}:{','.join(st.columns)}"
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_attach_table(s: SessionContext, st: A.AttachTable):
    """ATTACH TABLE name 'location' — a read-only table over another
    table's storage directory (reference EE attach_table)."""
    from ..license import check_feature
    check_feature(s, "attach_table")
    s.check_privilege("CREATE", st.database or s.current_database)
    from ..storage.fuse.table import AttachedTable
    db = st.database or s.current_database
    head = AttachedTable.head_snapshot_of(st.location)
    if head is None:
        raise BadArguments(f"no table snapshots found at {st.location!r}")
    if not head.schema:
        raise BadArguments(
            "source table predates schema-carrying snapshots; OPTIMIZE or "
            "re-append to it first")
    schema = TableSchema.from_dict(head.schema)
    info = TableInfo(0, db, st.name, schema, "ATTACH",
                     {"attach_location": st.location}, [])
    s.catalog.create_table(info, if_not_exists=False)
    return _ok()


def _stmt_create_network_policy(s: SessionContext, st: A.CreateNetworkPolicy):
    s.check_privilege("SUPER", "*")
    s.users.create_network_policy(st.name, st.allowed, st.blocked, st.comment,
                                  st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_network_policy(s: SessionContext, st: A.DropNetworkPolicy):
    s.check_privilege("SUPER", "*")
    s.users.drop_network_policy(st.name, st.if_exists)
    return _ok()


def _stmt_desc_network_policy(s: SessionContext, st: A.DescNetworkPolicy):
    p = s.users.get_network_policy(st.name)
    names = ["name", "allowed_ip_list", "blocked_ip_list", "comment"]
    vals = [p["name"], ",".join(p["allowed"]), ",".join(p["blocked"]),
            p.get("comment", "")]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_create_password_policy(s: SessionContext, st: A.CreatePasswordPolicy):
    s.check_privilege("SUPER", "*")
    s.users.create_password_policy(st.name, st.options, st.comment,
                                   st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_password_policy(s: SessionContext, st: A.DropPasswordPolicy):
    s.check_privilege("SUPER", "*")
    s.users.drop_password_policy(st.name, st.if_exists)
    return _ok()


def _stmt_desc_password_policy(s: SessionContext, st: A.DescPasswordPolicy):
    p = s.users.get_password_policy(st.name)
    names = ["name", "min_length", "max_length", "min_upper_case_chars",
             "min_lower_case_chars", "min_numeric_chars",
             "min_special_chars", "comment"]
    vals = [str(p.get(n, "")) for n in names]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_alter_user(s: SessionContext, st: A.AlterUser):
    # users may change their own password; policy changes need SUPER
    if st.network_policy is not ... or st.password_policy is not ... \
            or st.name.lower() != s.current_user.name.lower():
        s.check_privilege("SUPER", "*")
    s.users.alter_user(st.name, st.password, st.network_policy,
                       st.password_policy)
    return _ok()


_SECRET_CONN_KEYS = {"secret_access_key", "session_token", "password",
                     "credential", "master_key"}


def _stmt_create_connection(s: SessionContext, st: A.CreateConnection):
    """CREATE CONNECTION — named storage parameters (reference:
    src/meta/app-storage types + connection management). The data plane
    here uses the ambient credential chain (boto3); connections store and
    expose the parameter surface and are attachable to stages."""
    s.check_privilege("SUPER", "*")
    key = f"connections/{st.name.lower()}"
    got, _seq = s.meta.get(key)
    if got is not None and not st.or_replace:
        if st.if_not_exists:
            return _ok()
        raise BadArguments(f"connection {st.name!r} already exists")
    s.meta.upsert(key, {"name": st.name, "storage_type": st.storage_type,
                        "params": dict(st.params)})
    return _ok()


def _stmt_drop_connection(s: SessionContext, st: A.DropConnection):
    s.check_privilege("SUPER", "*")
    key = f"connections/{st.name.lower()}"
    got, _seq = s.meta.get(key)
    if got is None:
        if st.if_exists:
            return _ok()
        raise BadArguments(f"unknown connection {st.name!r}")
    s.meta.delete(key)
    return _ok()


def _redact_conn(params: dict) -> str:
    return " ".join(f"{k}={'***' if k in _SECRET_CONN_KEYS else v}"
                    for k, v in sorted(params.items()))


def _stmt_desc_connection(s: SessionContext, st: A.DescConnection):
    got, _seq = s.meta.get(f"connections/{st.name.lower()}")
    if got is None:
        raise BadArguments(f"unknown connection {st.name!r}")
    names = ["name", "storage_type", "storage_params"]
    vals = [got["name"], got["storage_type"], _redact_conn(got["params"])]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_begin(s: SessionContext, st: A.BeginTxn):
    """BEGIN: record every table's head snapshot so ROLLBACK can restore
    it (reference: multi-statement transactions; here snapshot-pointer
    semantics for the embedded single-writer case — the storage format is
    already MVCC, so rollback = repoint heads)."""
    if getattr(s, "_txn", None) is not None:
        raise SemanticError("a transaction is already active")
    heads = {}
    names = set()
    for d in s.catalog.list_databases():
        for info in s.catalog.list_tables(d.name):
            loc, _seq = s.catalog.get_snapshot_location(info.table_id)
            heads[info.table_id] = loc
            names.add((d.name.lower(), info.name.lower()))
    s._txn = {"heads": heads, "tables": names}
    return _ok()


def _stmt_commit(s: SessionContext, st: A.CommitTxn):
    if getattr(s, "_txn", None) is None:
        raise SemanticError("no active transaction")
    s._txn = None
    return _ok()


def _stmt_rollback(s: SessionContext, st: A.RollbackTxn):
    txn = getattr(s, "_txn", None)
    if txn is None:
        raise SemanticError("no active transaction")
    s._txn = None
    # restore snapshot pointers of pre-existing tables
    for d in s.catalog.list_databases():
        for info in list(s.catalog.list_tables(d.name)):
            if (d.name.lower(), info.name.lower()) not in txn["tables"]:
                # created inside the transaction: drop it
                s.catalog.drop_table(d.name, info.name, if_exists=True)
                continue
            want = txn["heads"].get(info.table_id, None)
            loc, seq = s.catalog.get_snapshot_location(info.table_id)
            if loc != want:
                s.catalog.set_snapshot_location(info.table_id, want, seq)
    # tables dropped inside the transaction: undrop and repoint to the
    # BEGIN-time snapshot (DROP is a soft delete, so the meta survives)
    present = {(d.name.lower(), i.name.lower())
               for d in s.catalog.list_databases()
               for i in s.catalog.list_tables(d.name)}
    for db_name, tbl_name in txn["tables"] - present:
        try:
            info = s.catalog.undrop_table(db_name, tbl_name)
        except Exception:
            continue  # dropped before the txn's BEGIN or already vacuumed
        want = txn["heads"].get(info.table_id, None)
        loc, seq = s.catalog.get_snapshot_location(info.table_id)
        if loc != want:
            s.catalog.set_snapshot_location(info.table_id, want, seq)
        s._tables.pop(info.table_id, None)
    s._result_cache.clear()
    return _ok()


def _stmt_set_table_comment(s: SessionContext, st: A.SetTableComment):
    s.check_privilege("ALTER", st.database or s.current_database, st.table)
    info = s.catalog.get_table(st.database or s.current_database, st.table)
    info.options["comment"] = st.comment
    s.catalog.update_table(info)
    s._tables.pop(info.table_id, None)
    return _ok()


def _stmt_kill(s: SessionContext, st: A.KillStmt):
    """KILL QUERY <id> — sets the query's abort flag; the executor raises
    AbortedQuery at its next between-blocks check (reference kill_stmt)."""
    from ..utils.processes import kill
    if not kill(st.object_id):
        raise BadArguments(f"no running query {st.object_id!r}")
    return _ok()


def _stmt_drop_procedure(s: SessionContext, st: A.DropProcedure):
    s.check_privilege("SUPER", "*")
    key = f"procedures/{st.name.lower()}"
    got, _seq = s.meta.get(key)
    if got is None:
        if st.if_exists:
            return _ok()
        raise BadArguments(f"unknown procedure {st.name!r}")
    s.meta.delete(key)
    return _ok()


def _stmt_call_procedure(s: SessionContext, st: A.CallProcedure):
    got, _seq = s.meta.get(f"procedures/{st.name.lower()}")
    if got is None:
        raise BadArguments(f"unknown procedure {st.name!r}")
    if len(st.args) != len(got["args"]):
        raise SemanticError(
            f"procedure {st.name!r} expects {len(got['args'])} args")
    env = {}
    one = DataBlock(["__r"], [Column.from_pylist([0], Int64)])
    for (aname, _atype), expr in zip(got["args"], st.args):
        env[aname] = _eval_insert_value(expr, one)
    from ..script import execute_script_block
    return execute_script_block(s, got["body"], env=env)


def _stmt_create_dictionary(s: SessionContext, st: A.CreateDictionary):
    s.check_privilege("SUPER", "*")
    from .dictionaries import DictionaryInfo
    cols = [(c.name, c.type_name) for c in st.columns]
    s.dictionaries.create(
        DictionaryInfo(st.name, cols, st.primary_key, st.source_kind or "TABLE",
                       dict(st.source_opts), st.comment),
        st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_dictionary(s: SessionContext, st: A.DropDictionary):
    s.check_privilege("SUPER", "*")
    s.dictionaries.drop(st.name, st.if_exists)
    return _ok()


def _stmt_show_create_dictionary(s: SessionContext, st: A.ShowCreateDictionary):
    info = s.dictionaries.get(st.name)
    names = ["Dictionary", "Create Dictionary"]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([info.name], String),
                          Column.from_pylist([info.ddl()], String)], 1),
        [DataField(n, String) for n in names])


def _stmt_create_sequence(s: SessionContext, st: A.CreateSequence):
    s.check_privilege("SUPER", "*")
    s.sequences.create(st.name, st.start, st.step, st.comment,
                       st.if_not_exists, st.or_replace)
    return _ok()


def _stmt_drop_sequence(s: SessionContext, st: A.DropSequence):
    s.check_privilege("SUPER", "*")
    s.sequences.drop(st.name, st.if_exists)
    return _ok()


def _stmt_desc_sequence(s: SessionContext, st: A.DescSequence):
    info = s.sequences.get(st.name)
    names = ["name", "start", "interval", "current", "comment"]
    vals = [info.name, str(info.start), str(info.step), str(info.current),
            info.comment]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_create_stage(s: SessionContext, st: A.CreateStage):
    s.check_privilege("SUPER", "*")
    s.stages.create(st.name, st.url, st.file_format, st.comment,
                    st.if_not_exists, st.or_replace,
                    connection=st.connection)
    return _ok()


def _stmt_drop_stage(s: SessionContext, st: A.DropStage):
    s.check_privilege("SUPER", "*")
    s.stages.drop(st.name, st.if_exists)
    return _ok()


def _stmt_desc_stage(s: SessionContext, st: A.DescStage):
    info = s.stages.get(st.name)
    names = ["name", "stage_type", "url", "file_format", "connection",
             "comment"]
    import json as _json
    vals = [info.name, info.stage_type, info.url,
            _json.dumps(info.file_format), _redact_conn(info.connection),
            info.comment]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _stmt_list_stage(s: SessionContext, st: A.ListStage):
    files = s.stages.list_files(st.ref, st.pattern)
    names = ["name", "size"]
    from ..types import UInt64
    return QueryResult(
        DataBlock(names, [Column.from_pylist([f[0] for f in files], String),
                          Column.from_pylist([f[1] for f in files], UInt64)],
                  len(files)),
        [DataField("name", String), DataField("size", UInt64)])


def _stmt_remove_stage(s: SessionContext, st: A.RemoveStage):
    s.check_privilege("SUPER", "*")
    return _ok(s.stages.remove(st.ref, st.pattern))


def _stmt_presign(s: SessionContext, st: A.PresignStage):
    s.check_privilege("SUPER", "*")
    p = s.stages.presign(st.ref, st.method, st.expire_secs)
    import json as _json
    names = ["method", "headers", "url"]
    vals = [p["method"], _json.dumps(p["headers"]), p["url"]]
    return QueryResult(
        DataBlock(names, [Column.from_pylist([v], String) for v in vals], 1),
        [DataField(n, String) for n in names])


def _validate_index_options(index_type: str, options: Dict[str, str]):
    """Reference-parity validation (interpreter_index_create.rs): a vector
    index requires a distance option with known metrics and positive
    m/ef_construct."""
    if index_type != "VECTOR":
        return
    distance = options.get("distance")
    if not distance:
        raise SemanticError("vector index requires a distance option "
                            "(one or more of cosine,l1,l2)")
    for m in distance.split(","):
        if m.strip() not in ("cosine", "l1", "l2"):
            raise SemanticError(f"unknown vector distance {m.strip()!r}")
    for knob in ("m", "ef_construct"):
        if knob in options:
            try:
                v = int(options[knob])
            except ValueError:
                raise SemanticError(f"vector index option {knob} must be "
                                    f"an integer")
            if v <= 0:
                raise SemanticError(f"vector index option {knob} must be "
                                    f"positive")


def _stmt_create_index(s: SessionContext, st: A.CreateIndex):
    db = st.database or s.current_database
    _validate_index_options(st.index_type, st.options)
    idx = TableIndexDef(st.name, st.index_type, st.columns, dict(st.options), st.sync)
    info = s.catalog.create_index(db, st.table, idx, st.if_not_exists)
    if st.sync:
        s.open_table(info).refresh_indexes(st.name)
    return _ok()


def _stmt_create_agg_index(s: SessionContext, st: A.CreateAggregatingIndex):
    """CREATE AGGREGATING INDEX idx AS SELECT .. GROUP BY .. — materialize
    per-block aggregate partials (reference TableIndexType::Aggregating;
    interpreter_index_create.rs). The definition must be a single-table
    grouped aggregate over plain columns with count/sum/min/max/avg."""
    import json as _json

    from ..pipeline.executor import _agg_index_shape
    from ..sql.binder import Binder
    from ..sql.plans import AggregatePlan, ProjectPlan, Scan
    plan = Binder(s).bind_query(st.query)
    node = plan
    while isinstance(node, ProjectPlan):
        node = node.child
    if not isinstance(node, AggregatePlan) or not node.keys:
        raise SemanticError(
            "AGGREGATING INDEX requires a GROUP BY aggregate query")
    scan = node.child
    while isinstance(scan, ProjectPlan):
        scan = scan.child
    if not isinstance(scan, Scan) or scan.pushdown.filters is not None:
        raise SemanticError(
            "AGGREGATING INDEX supports a single unfiltered table scan")
    keys, spec = _agg_index_shape(node)
    if keys is None:
        raise SemanticError(
            "AGGREGATING INDEX keys must be plain columns and aggregates"
            " one of count/sum/min/max/avg over a plain numeric column")
    info = scan.table.info
    idx = TableIndexDef(st.name, "AGGREGATING", keys,
                        {"definition": st.definition,
                         "aggs": _json.dumps(spec)}, st.sync)
    info = s.catalog.create_index(info.database, info.name, idx,
                                  st.if_not_exists)
    if st.sync:
        s.open_table(info).refresh_indexes(st.name)
    return _ok()


def _stmt_drop_index(s: SessionContext, st: A.DropIndex):
    if st.table:
        info = s.catalog.get_table(s.current_database, st.table)
        idx = info.indexes.get(st.name)
        if idx is not None and st.index_type \
                and idx.index_type != st.index_type:
            from ..errors import UnknownIndex
            raise UnknownIndex(
                f"index {st.name!r} is a {idx.index_type} index, not "
                f"{st.index_type}")
        # dropping the vector index behind a vector cluster key would
        # orphan the cluster definition (reference errors here too)
        if idx is not None and idx.index_type == "VECTOR":
            for ck in info.cluster_by:
                if ck.lower() in [c.lower() for c in idx.columns]:
                    raise SemanticError(
                        f"cannot drop vector index {st.name!r}: it backs "
                        f"cluster key `{ck}`")
    s.catalog.drop_index(s.current_database, st.table, st.name, st.if_exists)
    return _ok()


def _stmt_refresh_index(s: SessionContext, st: A.RefreshIndex):
    if st.table:
        info = s.catalog.get_table(s.current_database, st.table)
        tables = [info]
    else:
        tables = [t for t in s.catalog.list_tables(s.current_database)
                  if st.name in t.indexes]
    touched = 0
    for info in tables:
        if st.name in info.indexes:
            touched += s.open_table(info).refresh_indexes(st.name)
    return _ok(touched)


def _stmt_refresh_virtual_column(s: SessionContext,
                                 st: A.RefreshVirtualColumn):
    """REFRESH VIRTUAL COLUMN FOR t: (re)extract variant scalar leaf
    paths for every block (reference
    interpreter_virtual_column_refresh.rs). EE-gated."""
    from ..license import check_feature
    check_feature(s, "virtual_column")
    info = s.catalog.get_table(s.current_database, st.table)
    n = s.open_table(info).refresh_virtual_columns()
    return _ok(n)


def _computed_defs(info) -> Dict[str, tuple]:
    """{lower column name: (expr_sql, 'STORED'|'VIRTUAL')} from options."""
    out = {}
    for k, v in info.options.items():
        if k.startswith("computed:"):
            kind, _, expr = v.partition(":")
            out[k[len("computed:"):]] = (expr, kind)
    return out


def _fill_stored_computed(info, block: DataBlock, computed) -> DataBlock:
    """Evaluate STORED computed columns over the assembled insert block
    (reference: computed-column fill in the append pipeline)."""
    from ..service.policies import parse_policy_expr
    from ..sql.expr_binder import BindContext, ExprBinder
    names = list(block.names)
    cols = list(block.columns)
    ctx = BindContext()
    for n in names:
        f = info.schema.field(n)
        ctx.add(f.name, block.column(n).dtype, None, f.name)
    ev = Evaluator(block)
    for cname, (expr_sql, kind) in computed.items():
        if kind != "STORED":
            continue
        f = info.schema.field(cname)
        e = ExprBinder(ctx).bind(parse_policy_expr(expr_sql))
        col = ev.run(e)
        if col.dtype.remove_nullable() != f.dtype.remove_nullable():
            col = cast_column(col, f.dtype, False)
        names.append(f.name)
        cols.append(col)
    return DataBlock(names, cols, block.num_rows)


def _stmt_insert(s: SessionContext, st: A.Insert):
    db = st.database or s.current_database
    table = s.temp_table(db, st.table)
    if table is None:  # temp tables are session-private: no RBAC gate
        s.check_privilege("INSERT", db, st.table)
        info = s.catalog.get_table(db, st.table)
        table = s.open_table(info)
    else:
        info = table.info
    computed = _computed_defs(info)
    for c in (st.columns or []):
        if c.lower() in computed:
            raise SemanticError(f"cannot INSERT into computed column {c!r}")
    plain_fields = [n for n in info.schema.field_names()
                    if n.lower() not in computed]
    touched_streams = []
    if st.query is not None:
        from ..pipeline.executor import execute_plan
        from ..sql.binder import Binder
        binder = Binder(s)
        plan = binder.bind_query(st.query)
        block = execute_plan(plan)
        touched_streams = binder.touched_streams
        # INSERT .. SELECT maps columns by POSITION (the SELECT's output
        # names are expressions like "id % 7", never schema names), with
        # implicit casts to the target column types
        tgt_cols = st.columns or plain_fields
        if block.num_columns() != len(tgt_cols):
            raise SemanticError(
                f"INSERT SELECT arity mismatch: query yields "
                f"{block.num_columns()} columns, target expects {len(tgt_cols)}")
        out_cols = []
        for name, col in zip(tgt_cols, block.columns):
            f = info.schema.field(name)
            if col.dtype != f.dtype:
                col = cast_column(col, f.dtype, is_try=False)
            out_cols.append(col)
        block = DataBlock(tgt_cols, out_cols, block.num_rows)
    else:
        cols = st.columns or plain_fields
        if any(len(row) != len(cols) for row in st.values):
            raise SemanticError("INSERT VALUES row arity mismatch")
        data: Dict[str, list] = {c: [] for c in cols}
        one = DataBlock(["__r"], [Column.from_pylist([0], Int64)])
        for row in st.values:
            for c, e in zip(cols, row):
                data[c].append(_eval_insert_value(e, one))
        columns = []
        for c in cols:
            f = info.schema.field(c)
            target = f.dtype
            columns.append(Column.from_pylist(data[c], _insert_literal_type(data[c], target)))
        block = DataBlock(cols, columns, len(st.values))
    if computed:
        block = _fill_stored_computed(info, block, computed)
    table.append(block, overwrite=st.overwrite)
    # transactional stream consumption: a successful DML that read a
    # stream advances its watermark (reference storages/stream semantics)
    for sdb, sname in touched_streams:
        s.streams.advance(sdb, sname)
    return _ok(block.num_rows)


def _stmt_set_variable(s: SessionContext, st: A.SetVariable):
    """SET VARIABLE x = <expr> (reference: session variables + $x)."""
    from ..expression.evaluator import Evaluator
    from ..sql.expr_binder import BindContext, ExprBinder
    e = ExprBinder(BindContext()).bind(st.value)
    col = Evaluator(DataBlock([], [], 1)).run(e)
    s.variables[st.name.lower()] = col.get(0)
    return _ok(0)


def _stmt_unset_variable(s: SessionContext, st: A.UnsetVariable):
    s.variables.pop(st.name.lower(), None)
    return _ok(0)


def _stmt_multi_insert(s: SessionContext, st: A.MultiInsert):
    """INSERT ALL/FIRST [WHEN..THEN] INTO .. SELECT — multi-table insert
    (reference: multi-table insert interpreter). The source runs ONCE;
    each branch filters + projects it."""
    import numpy as np
    from ..expression.evaluator import Evaluator
    from ..pipeline.executor import execute_plan
    from ..sql.binder import Binder
    from ..sql.expr_binder import BindContext, ExprBinder

    src_plan = Binder(s).bind_query(st.query)
    block = execute_plan(src_plan)
    ctx = BindContext()
    for f in src_plan.output_fields():
        ctx.add(f.name, f.dtype)
    eb = ExprBinder(ctx)
    ev = Evaluator(block)
    n = block.num_rows

    def eval_mask(cond):
        col = ev.run(eb.bind(cond))
        vals = col.to_pylist()
        return np.array([bool(v) for v in vals], np.bool_)

    def do_insert(br, mask):
        rows = block.filter(mask) if not mask.all() else block
        if rows.num_rows == 0:
            return 0
        db = br.database or s.current_database
        table = s.temp_table(db, br.table)
        if table is None:
            s.check_privilege("INSERT", db, br.table)
            table = s.open_table(s.catalog.get_table(db, br.table))
        info = table.info
        computed = _computed_defs(info)
        plain = [fn for fn in info.schema.field_names()
                 if fn.lower() not in computed]
        tgt = br.columns or plain
        if br.values is not None:
            exprs = [eb.bind(e) for e in br.values]
            ev_rows = Evaluator(rows)
            out_cols = [ev_rows.run(e) for e in exprs]
        else:
            out_cols = list(rows.columns)
        if len(out_cols) != len(tgt):
            raise SemanticError(
                f"multi-insert branch into {br.table!r} arity mismatch:"
                f" {len(out_cols)} values for {len(tgt)} columns")
        cast_cols = []
        for name, col in zip(tgt, out_cols):
            f = info.schema.field(name)
            if col.dtype != f.dtype:
                col = cast_column(col, f.dtype, is_try=False)
            cast_cols.append(col)
        out = DataBlock(tgt, cast_cols, rows.num_rows)
        if computed:
            out = _fill_stored_computed(info, out, computed)
        table.append(out, overwrite=st.overwrite)
        return out.num_rows

    total = 0
    claimed = np.zeros(n, np.bool_)
    any_when = np.zeros(n, np.bool_)
    cond_masks: Dict[int, "np.ndarray"] = {}
    for br in st.branches:
        key = id(br.condition)
        if key not in cond_masks:
            mask = (np.ones(n, np.bool_) if br.condition is None
                    else eval_mask(br.condition))
            if br.condition is not None:
                any_when |= mask
            if st.first:
                mask = mask & ~claimed
                claimed |= mask
            cond_masks[key] = mask
        total += do_insert(br, cond_masks[key])
    if st.else_branches:
        rest = ~any_when
        if st.first:
            rest &= ~claimed
        for br in st.else_branches:
            total += do_insert(br, rest)
    return _ok(total)


def _stmt_replace_into(s: SessionContext, st: A.ReplaceInto):
    """REPLACE INTO ... ON (keys): delete target rows whose conflict keys
    match any incoming row, then append the incoming rows (reference:
    replace-into with bloom-pruned conflict detection)."""
    from ..expression.expr import BoundColumn, CastExpr, Constant, Func
    from ..types import ArrayType, Boolean
    s.check_privilege("INSERT", st.database or s.current_database, st.table)
    db = st.database or s.current_database
    table = s.temp_table(db, st.table) or s.open_table(
        s.catalog.get_table(db, st.table))
    info = table.info
    computed = _computed_defs(info)
    plain_fields = [n for n in info.schema.field_names()
                    if n.lower() not in computed]
    cols = st.columns or plain_fields
    for k in st.on_keys:
        if k not in [c for c in cols] and not info.schema.has_field(k):
            raise SemanticError(f"conflict key {k!r} not found")
    if st.query is not None:
        from ..pipeline.executor import execute_plan
        from ..sql.binder import Binder
        block = execute_plan(Binder(s).bind_query(st.query))
        if block.num_columns() != len(cols):
            raise SemanticError("REPLACE INTO SELECT arity mismatch")
        out_cols = []
        for name, col in zip(cols, block.columns):
            f = info.schema.field(name)
            if col.dtype != f.dtype:
                col = cast_column(col, f.dtype, is_try=False)
            out_cols.append(col)
        block = DataBlock(cols, out_cols, block.num_rows)
    else:
        if any(len(row) != len(cols) for row in st.values):
            raise SemanticError("REPLACE INTO VALUES row arity mismatch")
        data: Dict[str, list] = {c: [] for c in cols}
        one = DataBlock(["__r"], [Column.from_pylist([0], Int64)])
        for row in st.values:
            for c, e in zip(cols, row):
                data[c].append(_eval_insert_value(e, one))
        block = DataBlock(cols, [
            Column.from_pylist(data[c],
                               _insert_literal_type(data[c],
                                                    info.schema.field(c).dtype))
            for c in cols], len(st.values))
    if computed:
        block = _fill_stored_computed(info, block, computed)
    # delete conflicting target rows: typed per-column tuple matching
    # (null-safe — NULL keys conflict with NULL keys), not stringified
    # concat, so bool/float/timestamp representations can't disagree
    if table.read_snapshot() is not None and block.num_rows:
        key_names = [info.schema.field(k).name for k in st.on_keys]
        key_cols = [block.column(n).to_pylist() for n in key_names]
        incoming = set(zip(*key_cols)) if len(key_names) > 1 \
            else set(key_cols[0])

        def conflict_mask(target_block):
            import numpy as _np
            cols = [target_block.column(n).to_pylist() for n in key_names]
            rows = zip(*cols) if len(key_names) > 1 else cols[0]
            return _np.fromiter((r in incoming for r in rows), _np.bool_,
                                target_block.num_rows)
        table.delete_rows(conflict_mask)
    table.append(block)
    return _ok(block.num_rows)


def _insert_literal_type(values, target):
    # vectors arrive as python lists; other types use the column's own type
    from ..types import ArrayType, VectorType
    t = target.remove_nullable()
    if isinstance(t, (VectorType,)):
        return target
    return target


def _eval_insert_value(e: A.Expr, one: DataBlock):
    from ..sql.expr_binder import BindContext, ExprBinder
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.UnaryOp) and e.op == "-" and isinstance(e.operand, A.Literal):
        return -e.operand.value
    bound = ExprBinder(BindContext()).bind(e)
    col = Evaluator(one).run(bound)
    return col.get(0)


def _stmt_delete(s: SessionContext, st: A.Delete):
    s.check_privilege("DELETE", st.database or s.current_database, st.table)

    table = s.table(st.table, st.database)
    expr = None
    if st.where is not None:
        from ..sql.expr_binder import BindContext, ExprBinder
        ctx = BindContext()
        for f in table.schema.fields:
            ctx.add(f.name, f.dtype)
        expr = ExprBinder(ctx).bind(st.where)
    n = table.delete_rows(expr)
    return _ok(n)


def _stmt_update(s: SessionContext, st: A.Update):
    s.check_privilege("UPDATE", st.database or s.current_database, st.table)

    table = s.table(st.table, st.database)
    from ..sql.expr_binder import BindContext, ExprBinder
    ctx = BindContext()
    for f in table.schema.fields:
        ctx.add(f.name, f.dtype)
    binder = ExprBinder(ctx)
    where = binder.bind(st.where) if st.where is not None else None
    assignments = [(c, binder.bind(e)) for c, e in st.assignments]
    n = table.update_rows(where, assignments)
    return _ok(n)


def _stmt_create_warehouse(s: SessionContext, st: A.CreateWarehouse):
    """Warehouse objects on the meta KV (reference management/warehouse +
    ee resource_management): a named compute entity tasks/queries can be
    pinned to. In the TPU engine a warehouse maps onto a mesh slice, so
    the object carries size/status metadata and task affinity."""
    s.check_privilege("SUPER", "*")
    key = f"warehouses/{st.name.lower()}"
    got, _seq = s.meta.get(key)
    if got is not None:
        if st.if_not_exists:
            return _ok()
        raise BadArguments(f"warehouse {st.name!r} already exists")
    import time as _t
    s.meta.upsert(key, {"name": st.name, "status": "Running",
                        "size": st.options.get("warehouse_size", "Small"),
                        "options": dict(st.options), "created_ts": _t.time()})
    return _ok()


def _stmt_create_workload_group(s: SessionContext,
                                st: A.CreateWorkloadGroup):
    """Workload groups (reference ee resource_management): quota bundles
    (max_concurrency / memory_quota / query_timeout) that warehouses
    attach via `CREATE WAREHOUSE w WITH workload_group='g'`."""
    from ..license import check_feature
    check_feature(s, "workload_group")
    s.check_privilege("SUPER", "*")
    from .workload import WorkloadManager
    WorkloadManager(s).create(st.name, st.options, st.if_not_exists)
    return _ok()


def _stmt_alter_workload_group(s: SessionContext,
                               st: A.AlterWorkloadGroup):
    s.check_privilege("SUPER", "*")
    from .workload import WorkloadManager
    WorkloadManager(s).alter(st.name, st.options)
    return _ok()


def _stmt_drop_workload_group(s: SessionContext, st: A.DropWorkloadGroup):
    s.check_privilege("SUPER", "*")
    from .workload import WorkloadManager
    WorkloadManager(s).drop(st.name, st.if_exists)
    return _ok()


def _stmt_drop_warehouse(s: SessionContext, st: A.DropWarehouse):
    s.check_privilege("SUPER", "*")
    key = f"warehouses/{st.name.lower()}"
    got, _seq = s.meta.get(key)
    if got is None:
        if st.if_exists:
            return _ok()
        raise BadArguments(f"unknown warehouse {st.name!r}")
    s.meta.delete(key)
    return _ok()


def _stmt_alter_warehouse(s: SessionContext, st: A.AlterWarehouse):
    s.check_privilege("SUPER", "*")
    key = f"warehouses/{st.name.lower()}"
    got, seq = s.meta.get(key)
    if got is None:
        raise BadArguments(f"unknown warehouse {st.name!r}")
    got["status"] = "Suspended" if st.action == "SUSPEND" else "Running"
    s.meta.upsert(key, got)
    return _ok()


def _stmt_use_warehouse(s: SessionContext, st: A.UseWarehouse):
    got, _seq = s.meta.get(f"warehouses/{st.name.lower()}")
    if got is None:
        raise BadArguments(f"unknown warehouse {st.name!r}")
    s.current_warehouse = got["name"]
    return _ok()


def _stmt_show(s: SessionContext, st: A.ShowStmt):
    import fnmatch
    like = st.like
    def match(name):
        if like is None:
            return True
        return fnmatch.fnmatch(name.lower(), like.lower().replace("%", "*").replace("_", "?"))
    if st.what == "DATABASES":
        names = sorted(d.name for d in s.catalog.list_databases() if match(d.name))
        return QueryResult(DataBlock(["database"], [Column.from_pylist(names, String)]),
                           [DataField("database", String)])
    if st.what == "TABLES":
        db = st.from_db or s.current_database
        if db.lower() == "system":
            # the system database is virtual: list the registered system
            # tables (reference src/query/storages/system lists them in
            # SHOW TABLES FROM system too)
            from .system_tables import SYSTEM_TABLES
            names = sorted(n for n in SYSTEM_TABLES if match(n))
        else:
            names = sorted(t.name for t in s.catalog.list_tables(db)
                           if match(t.name))
        return QueryResult(DataBlock(["table"], [Column.from_pylist(names, String)]),
                           [DataField("table", String)])
    if st.what == "SETTINGS":
        rows = [r for r in s.settings.all() if match(r[0])]
        return QueryResult(DataBlock(
            ["name", "value", "default", "description"],
            [Column.from_pylist([str(r[i]) for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in ("name", "value", "default", "description")])
    if st.what == "VIRTUAL COLUMNS":
        # reference ShowVirtualColumnsStmt: the registry behind
        # system.virtual_columns, optionally filtered to one table
        from .system_tables import SYSTEM_TABLES
        blk, _ = SYSTEM_TABLES["virtual_columns"](s)
        rows = [tuple(c.get(i) for c in blk.columns)
                for i in range(blk.num_rows)
                if (st.from_db is None
                    or blk.column("table").get(i).lower()
                    == st.from_db.lower())
                and match(blk.column("table").get(i))]
        cols = [Column.from_pylist([r[i] for r in rows], String)
                for i in range(3)]
        names = ["database", "table", "virtual_columns"]
        return QueryResult(DataBlock(names, cols, len(rows)),
                           [DataField(n, String) for n in names])
    if st.what == "FUNCTIONS":
        from ..expression.functions import registry
        from ..expression.functions.aggregates import AGGREGATE_FUNCTIONS
        names = sorted(set(registry.names()) | set(AGGREGATE_FUNCTIONS))
        names = [n for n in names if match(n)]
        return QueryResult(DataBlock(["name"], [Column.from_pylist(names, String)]),
                           [DataField("name", String)])
    if st.what == "WAREHOUSES":
        rows = [(v["name"], "Standard", v.get("status", "Running"),
                 v.get("size", "Small"))
                for _k, v, _s2 in s.meta.list_prefix("warehouses/")
                if match(v["name"])]
        rows.sort()
        names = ["name", "type", "status", "size"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String)
                    for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "WORKLOAD_GROUPS":
        from .workload import WorkloadManager
        rows = [(g["name"],
                 g["options"].get("max_concurrency", ""),
                 g["options"].get("memory_quota", ""),
                 g["options"].get("query_timeout", ""),
                 g["options"].get("cpu_quota", ""))
                for g in WorkloadManager(s).list() if match(g["name"])]
        names = ["name", "max_concurrency", "memory_quota",
                 "query_timeout", "cpu_quota"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([str(r[i]) for r in rows], String)
                    for i in range(5)]),
            [DataField(n, String) for n in names])
    if st.what == "TASKS":
        rows = [(t["name"], t["state"], str(t["schedule_secs"]), t["sql"])
                for t in s.tasks.list()]
        names = ["name", "state", "schedule_secs", "definition"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "STREAMS":
        rows = [(key.split("/", 1)[1], v["table_database"] + "." + v["table_name"],
                 v["watermark"] or "") for key, v in s.streams.list()]
        names = ["name", "table", "watermark"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(3)]),
            [DataField(n, String) for n in names])
    if st.what == "NETWORK_POLICIES":
        rows = [(p["name"], ",".join(p["allowed"]), ",".join(p["blocked"]),
                 p.get("comment", ""))
                for p in s.users.list_network_policies() if match(p["name"])]
        names = ["name", "allowed_ip_list", "blocked_ip_list", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "PASSWORD_POLICIES":
        rows = [(p["name"], str(p["min_length"]), str(p["max_length"]),
                 p.get("comment", ""))
                for p in s.users.list_password_policies() if match(p["name"])]
        names = ["name", "min_length", "max_length", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "MASKING_POLICIES":
        rows = [(p.name, p.body, p.comment)
                for p in s.policies.list_masking() if match(p.name)]
        names = ["name", "body", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(3)]),
            [DataField(n, String) for n in names])
    if st.what == "ROW_ACCESS_POLICIES":
        rows = [(p.name, p.body, p.comment)
                for p in s.policies.list_row_access() if match(p.name)]
        names = ["name", "body", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(3)]),
            [DataField(n, String) for n in names])
    if st.what == "CONNECTIONS":
        rows = sorted((v for _, v, _ in s.meta.list_prefix("connections/")),
                      key=lambda c: c["name"])
        rows = [(c["name"], c["storage_type"], _redact_conn(c["params"]))
                for c in rows if match(c["name"])]
        names = ["name", "storage_type", "storage_params"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(3)]),
            [DataField(n, String) for n in names])
    if st.what == "PROCESSLIST":
        from ..utils.processes import list_running
        rows = sorted(list_running(), key=lambda e: e["start"])
        names = ["id", "user", "extra_info"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([e["id"] for e in rows], String),
                    Column.from_pylist([e["user"] for e in rows], String),
                    Column.from_pylist([e["sql"] for e in rows], String)]),
            [DataField(n, String) for n in names])
    if st.what == "PROCEDURES":
        rows = sorted((v for _, v, _ in s.meta.list_prefix("procedures/")),
                      key=lambda p: p["name"])
        rows = [(p["name"],
                 ", ".join(f"{n} {t}" for n, t in p["args"]))
                for p in rows if match(p["name"])]
        names = ["name", "arguments"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(2)]),
            [DataField(n, String) for n in names])
    if st.what == "DICTIONARIES":
        rows = [(i.name, i.primary_key, i.source_kind, i.comment)
                for i in s.dictionaries.list() if match(i.name)]
        names = ["name", "key_names", "source", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "SEQUENCES":
        rows = [(i.name, str(i.start), str(i.step), str(i.current), i.comment)
                for i in s.sequences.list() if match(i.name)]
        names = ["name", "start", "interval", "current", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(5)]),
            [DataField(n, String) for n in names])
    if st.what == "STAGES":
        rows = [(i.name, i.stage_type, i.url, i.comment)
                for i in s.stages.list() if match(i.name)]
        names = ["name", "stage_type", "url", "comment"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "INDEXES":
        rows = []
        for t in s.catalog.list_tables(s.current_database):
            for idx in t.indexes.values():
                rows.append((idx.name, idx.index_type.lower(), t.name,
                             ",".join(idx.columns)))
        names = ["name", "type", "table", "columns"]
        return QueryResult(DataBlock(
            names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
            [DataField(n, String) for n in names])
    if st.what == "VARIABLES":
        return _stmt_show(s, A.ShowStmt("SETTINGS", None, st.like))
    # generic fallback: SHOW <word> renders the matching system table
    # (USERS, ROLES, ENGINES, CATALOGS, METRICS, ...)
    from .system_tables import SYSTEM_TABLES
    if st.what.lower() in SYSTEM_TABLES:
        from ..pipeline.executor import execute_plan
        from .system_tables import system_table_plan
        plan = system_table_plan(s, st.what.lower())
        block = execute_plan(plan)
        if st.like is not None and block.num_columns():
            first = block.columns[0].to_pylist()
            keep = np.array([match(str(v)) for v in first], np.bool_)
            block = block.filter(keep)
        return QueryResult(block, plan.output_fields())
    raise UnsupportedFeature(f"SHOW {st.what} not supported")


def _stmt_describe(s: SessionContext, st: A.DescribeTable):
    db = st.database or s.current_database
    temp = s.temp_table(db, st.name)
    info = temp.info if temp is not None else s.catalog.get_table(db, st.name)
    names = ["field", "type", "null", "default"]
    rows = [(f.name, f.dtype.remove_nullable().sql_name(),
             "YES" if f.dtype.is_nullable() else "NO",
             "" if f.default is None else str(f.default)) for f in info.schema.fields]
    return QueryResult(DataBlock(
        names, [Column.from_pylist([r[i] for r in rows], String) for i in range(4)]),
        [DataField(n, String) for n in names])


def _stmt_set(s: SessionContext, st: A.SetSetting):
    if st.is_global:
        s.check_privilege("SUPER", "*")
    s.settings.set(st.name, st.value, st.is_global)
    if st.is_global:
        # global scope persists in the meta service (reference
        # settings_global.rs: meta-backed global settings)
        s.meta.upsert(f"settings/{st.name.lower()}",
                      s.settings.get(st.name))
    return _ok()


def _stmt_analyze(s: SessionContext, st: A.AnalyzeTable):
    """ANALYZE TABLE: compute NDV + equi-height histograms for the CBO
    (reference: interpreter_table_analyze.rs + src/common/statistics)."""
    from ..statistics import analyze_table
    t = s.table(st.name, st.database)
    stats = analyze_table(s, t)
    return _ok(stats.row_count)


def _stmt_optimize(s: SessionContext, st: A.OptimizeTable):
    import time as _t
    t = s.table(st.name, st.database)
    if st.action == "RECLUSTER":
        t0 = _t.time()
        snap_before = t.read_snapshot()
        n_blocks = t.recluster()
        # clustering_history (reference clustering_history_table.rs)
        hist = {"table": f"{t.info.database}.{t.info.name}",
                "started": t0, "duration_ms": (_t.time() - t0) * 1e3,
                "blocks_before": snap_before.block_count if snap_before else 0,
                "blocks_after": n_blocks}
        s.meta.upsert(f"clustering_history/{int(t0 * 1e6)}", hist)
        return _ok(n_blocks)
    if st.action in ("COMPACT", "ALL"):
        t.compact()
    if st.action in ("PURGE", "ALL"):
        t.vacuum(float(s.settings.get("data_retention_time_in_days") or 0))
    return _ok()


def _stmt_vacuum(s: SessionContext, st: A.VacuumTable):
    from ..license import check_feature
    check_feature(s, "vacuum")  # EE-gated in the reference
    removed = s.table(st.name, st.database).vacuum(
        float(s.settings.get("data_retention_time_in_days") or 0))
    return _ok(removed)


def _stmt_create_catalog(s: SessionContext, st: A.CreateCatalog):
    key = f"catalogs/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is not None and not st.or_replace:
        if st.if_not_exists:
            return _ok()
        from ..errors import DatabaseAlreadyExists
        raise DatabaseAlreadyExists(f"catalog {st.name!r} already exists")
    if st.catalog_type.upper() not in ("ICEBERG", "PAIMON"):
        raise UnsupportedFeature(
            f"unsupported catalog type {st.catalog_type!r}")
    loc = st.options.get("location") or st.options.get("url")
    if not loc:
        raise BadArguments("CREATE CATALOG requires LOCATION or "
                           "CONNECTION=(URL=...)")
    s.meta.upsert(key, {"type": st.catalog_type.upper(),
                        "options": dict(st.options)})
    return _ok()


def _stmt_drop_catalog(s: SessionContext, st: A.DropCatalog):
    key = f"catalogs/{st.name.lower()}"
    cur, _ = s.meta.get(key)
    if cur is None:
        if st.if_exists:
            return _ok()
        from ..errors import UnknownCatalog
        raise UnknownCatalog(f"unknown catalog {st.name!r}")
    s.meta.delete(key)
    s._catalog_tables.clear()
    return _ok()


def _stmt_show_catalogs(s: SessionContext, st: A.ShowCatalogs):
    names = ["default"]
    types = ["DEFAULT"]
    for k, v, _ in s.meta.list_prefix("catalogs/"):
        names.append(k.split("/", 1)[1])
        types.append(v.get("type", "ICEBERG"))
    return QueryResult(DataBlock(
        ["name", "type"],
        [Column.from_pylist(names, String), Column.from_pylist(types, String)]),
        [DataField("name", String), DataField("type", String)])


def _stmt_prepare(s: SessionContext, st: A.PrepareStmt):
    from .prepared import PreparedStatement
    s._prepared[st.name.lower()] = PreparedStatement(s, st.sql)
    return _ok()


def _prepared_param_value(e: A.Expr):
    """Constant-fold an EXECUTE ... USING argument."""
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.UnaryOp) and e.op == "-" \
            and isinstance(e.operand, A.Literal):
        return -e.operand.value
    from ..errors import BadArguments
    raise BadArguments("EXECUTE parameters must be constants")


def _stmt_execute_prepared(s: SessionContext, st: A.ExecutePrepared):
    ps = s._prepared.get(st.name.lower())
    if ps is None:
        from ..errors import BadArguments
        raise BadArguments(f"unknown prepared statement {st.name!r}")
    return ps.execute(*[_prepared_param_value(p) for p in st.params])


def _stmt_deallocate(s: SessionContext, st: A.DeallocateStmt):
    if s._prepared.pop(st.name.lower(), None) is None:
        from ..errors import BadArguments
        raise BadArguments(f"unknown prepared statement {st.name!r}")
    return _ok()


_STATEMENTS = {
    A.CreateCatalog: _stmt_create_catalog,
    A.DropCatalog: _stmt_drop_catalog,
    A.ShowCatalogs: _stmt_show_catalogs,
    A.PrepareStmt: _stmt_prepare,
    A.ExecutePrepared: _stmt_execute_prepared,
    A.DeallocateStmt: _stmt_deallocate,
    A.CreateDatabase: _stmt_create_database,
    A.DropDatabase: _stmt_drop_database,
    A.UseDatabase: _stmt_use,
    A.CreateTable: _stmt_create_table,
    A.DropTable: _stmt_drop_table,
    A.TruncateTable: _stmt_truncate,
    A.RenameTable: _stmt_rename,
    A.FlashbackTable: _stmt_flashback,
    A.CopyIntoTable: _stmt_copy_into_table,
    A.CopyIntoLocation: _stmt_copy_into_location,
    A.CreateFunction: _stmt_create_function,
    A.DropFunction: _stmt_drop_function,
    A.CreateStream: _stmt_create_stream,
    A.DropStream: _stmt_drop_stream,
    A.CreateView: _stmt_create_view,
    A.DropView: _stmt_drop_view,
    A.MergeInto: _stmt_merge,
    A.UndropTable: _stmt_undrop,
    A.ShowCreateTable: _stmt_show_create,
    A.CreateTask: _stmt_create_task,
    A.DropTask: _stmt_drop_task,
    A.AlterTask: _stmt_alter_task,
    A.ExecuteTask: _stmt_execute_task,
    A.CreateUser: _stmt_create_user,
    A.DropUser: _stmt_drop_user,
    A.CreateRole: _stmt_create_role,
    A.DropRole: _stmt_drop_role,
    A.GrantRole: _stmt_grant_role,
    A.GrantPrivileges: _stmt_grant_privileges,
    A.ShowGrants: _stmt_show_grants,
    A.CreateIndex: _stmt_create_index,
    A.CreateAggregatingIndex: _stmt_create_agg_index,
    A.DropIndex: _stmt_drop_index,
    A.RefreshIndex: _stmt_refresh_index,
    A.RefreshVirtualColumn: _stmt_refresh_virtual_column,
    A.Insert: _stmt_insert,
    A.MultiInsert: _stmt_multi_insert,
    A.SetVariable: _stmt_set_variable,
    A.UnsetVariable: _stmt_unset_variable,
    A.UnsetSetting: lambda s, st: (s.settings.unset(st.name), _ok())[1],
    A.ReplaceInto: _stmt_replace_into,
    A.Delete: _stmt_delete,
    A.Update: _stmt_update,
    A.ShowStmt: _stmt_show,
    A.CreateWarehouse: _stmt_create_warehouse,
    A.DropWarehouse: _stmt_drop_warehouse,
    A.AlterWarehouse: _stmt_alter_warehouse,
    A.CreateWorkloadGroup: _stmt_create_workload_group,
    A.AlterWorkloadGroup: _stmt_alter_workload_group,
    A.DropWorkloadGroup: _stmt_drop_workload_group,
    A.UseWarehouse: _stmt_use_warehouse,
    A.DescribeTable: _stmt_describe,
    A.SetSetting: _stmt_set,
    A.OptimizeTable: _stmt_optimize,
    A.AnalyzeTable: _stmt_analyze,
    A.VacuumTable: _stmt_vacuum,
    A.AddColumn: _stmt_add_column,
    A.DropColumn: _stmt_drop_column,
    A.RenameColumn: _stmt_rename_column,
    A.CreateMaskingPolicy: _stmt_create_masking_policy,
    A.DropMaskingPolicy: _stmt_drop_masking_policy,
    A.DescMaskingPolicy: _stmt_desc_masking_policy,
    A.CreateRowAccessPolicy: _stmt_create_row_access_policy,
    A.DropRowAccessPolicy: _stmt_drop_row_access_policy,
    A.SetColumnMaskingPolicy: _stmt_set_column_masking_policy,
    A.SetTableRowAccessPolicy: _stmt_set_table_row_access_policy,
    A.AttachTable: _stmt_attach_table,
    A.CreateNetworkPolicy: _stmt_create_network_policy,
    A.DropNetworkPolicy: _stmt_drop_network_policy,
    A.DescNetworkPolicy: _stmt_desc_network_policy,
    A.CreatePasswordPolicy: _stmt_create_password_policy,
    A.DropPasswordPolicy: _stmt_drop_password_policy,
    A.DescPasswordPolicy: _stmt_desc_password_policy,
    A.AlterUser: _stmt_alter_user,
    A.CreateConnection: _stmt_create_connection,
    A.DropConnection: _stmt_drop_connection,
    A.DescConnection: _stmt_desc_connection,
    A.BeginTxn: _stmt_begin,
    A.CommitTxn: _stmt_commit,
    A.RollbackTxn: _stmt_rollback,
    A.SetTableComment: _stmt_set_table_comment,
    A.KillStmt: _stmt_kill,
    A.DropProcedure: _stmt_drop_procedure,
    A.CallProcedure: _stmt_call_procedure,
    A.CreateDictionary: _stmt_create_dictionary,
    A.DropDictionary: _stmt_drop_dictionary,
    A.ShowCreateDictionary: _stmt_show_create_dictionary,
    A.CreateSequence: _stmt_create_sequence,
    A.DropSequence: _stmt_drop_sequence,
    A.DescSequence: _stmt_desc_sequence,
    A.CreateStage: _stmt_create_stage,
    A.DropStage: _stmt_drop_stage,
    A.DescStage: _stmt_desc_stage,
    A.ListStage: _stmt_list_stage,
    A.RemoveStage: _stmt_remove_stage,
    A.PresignStage: _stmt_presign,
}
