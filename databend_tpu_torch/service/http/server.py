"""HTTP query endpoint — the `/v1/query` protocol.

TPU-native re-design of the reference's poem handlers
(src/query/service/src/servers/http/v1/{http_query_handlers.rs,
query/execute_state.rs:401}): POST a SQL statement, receive the first page
plus a `next_uri` for pagination; `/final` acknowledges completion,
`/kill` cancels. Also serves `/v1/health` and a Prometheus-style
`/v1/metrics` (reference MetricService, src/binaries/query/entry.rs:205).

Queries execute in a worker thread (the engine itself dispatches jitted
XLA programs; the host side is orchestration only). State machine mirrors
ExecuteStateKind: Starting -> Running -> Succeeded | Failed.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ...errors import DatabendError
from ..session import QueryResult, SessionContext

PAGE_ROWS = 10_000


def _json_value(v):
    """Render a cell the way the reference's JSON output does: everything a
    string, NULL as None, vectors as '[x,y,...]'."""
    if v is None:
        return None
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return repr(v)
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(str(_json_value(x)) for x in v) + "]"
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return str(v)


class HttpQuery:
    """One tracked query (reference HttpQueryManager + ExecuteState)."""

    def __init__(self, qid: str, sql: str, params=None, prepared=None):
        self.id = qid
        self.sql = sql
        self.params = params          # positional `?` bindings, or None
        self.prepared = prepared      # cached PreparedStatement, or None
        self.state = "Starting"
        self.error: Optional[Dict[str, Any]] = None
        self.result: Optional[QueryResult] = None
        self.started = time.time()
        self.finished_at: Optional[float] = None
        self.pages: List[List[list]] = []
        self.schema: List[Dict[str, str]] = []
        self.stats: Dict[str, Any] = {}

    def run(self, ctx: SessionContext) -> None:
        self.state = "Running"
        try:
            if self.prepared is not None:
                res = self.prepared.execute(*(self.params or []))
            else:
                res = ctx.sql(self.sql)
            self.result = res
            self.schema = [{"name": f.name, "type": str(f.dtype)}
                           for f in res.fields]
            # STREAMED paging (reference execute_state.rs:401 semantics):
            # the columnar result stays as-is; each page's JSON renders
            # on demand in page_response and is never retained — a large
            # SELECT holds one columnar block, not its (several-times
            # larger) JSON materialization
            n = res.block.num_rows if res.block is not None else 0
            self.n_rows = n
            self.n_pages = max((n + PAGE_ROWS - 1) // PAGE_ROWS, 1)
            self.stats = {
                "rows": n,
                "affected_rows": res.affected_rows,
                "running_time_ms": (time.time() - self.started) * 1e3,
                **res.profile,
            }
            self.state = "Succeeded"
        except DatabendError as e:
            self.error = {"code": getattr(e, "code", 1000), "message": str(e)}
            self.state = "Failed"
        except Exception as e:  # engine bug surfaced as internal error
            self.error = {"code": 1001, "message": f"{type(e).__name__}: {e}"}
            self.state = "Failed"
        finally:
            self.finished_at = time.time()

    def _render_page(self, page_no: int) -> List[list]:
        if self.result is None or self.result.block is None:
            return []
        lo = page_no * PAGE_ROWS
        hi = min(lo + PAGE_ROWS, self.result.block.num_rows)
        if lo >= hi:
            return []
        page = QueryResult(self.result.block.slice(lo, hi),
                           self.result.fields)
        return [[_json_value(v) for v in row] for row in page.rows()]

    def release(self) -> None:
        """Drop the columnar result once the client read the final page."""
        self.result = None

    def page_response(self, page_no: int) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "id": self.id,
            "state": self.state,
            "schema": self.schema,
            "stats": self.stats,
            "error": self.error,
        }
        if self.state == "Succeeded" and page_no < getattr(self, "n_pages", 0):
            body["data"] = self._render_page(page_no)
            if page_no + 1 < self.n_pages:
                body["next_uri"] = f"/v1/query/{self.id}/page/{page_no + 1}"
            else:
                body["final_uri"] = f"/v1/query/{self.id}/final"
        else:
            body["data"] = []
            if self.state in ("Starting", "Running"):
                body["next_uri"] = f"/v1/query/{self.id}/page/{page_no}"
        return body


class QueryServer:
    """aiohttp application hosting the query protocol over one engine."""

    def __init__(self, data_root: str = ".databend_tpu",
                 max_finished: int = 256, address: str = "",
                 meta_endpoint: Optional[str] = None,
                 heartbeat_secs: float = 0.0,
                 lease_ttl_secs: Optional[float] = None):
        self.ctx = SessionContext(data_root=data_root,
                                  meta_endpoint=meta_endpoint)
        self.queries: Dict[str, HttpQuery] = {}
        self._lock = threading.Lock()
        self._max_finished = max_finished
        # admission control (reference QueriesQueueManager, queue_mgr.rs):
        # bounds concurrent executions; waiters time out with a queue error
        from ...utils.memstat import QueryQueue
        try:
            limit = int(self.ctx.settings.get("max_running_queries") or 0)
            timeout = float(self.ctx.settings.get(
                "statement_queued_timeout_in_seconds") or 60)
        except Exception:
            limit, timeout = 0, 60.0
        self._queue = QueryQueue(limit, timeout)
        # server-side prepared-plan cache keyed by (user, sql): parameterized
        # requests bind once; the KNN shape then serves from the resident
        # corpus (reference has no analog — execute_state.rs re-plans)
        self._prep_cache: Dict[tuple, object] = {}
        self._prep_lock = threading.Lock()
        # register this server process in the cluster registry
        # (reference ClusterDiscovery::register_to_metastore)
        from ...meta.cluster import ClusterDiscovery
        kw = {"ttl_secs": lease_ttl_secs} if lease_ttl_secs else {}
        self.discovery = ClusterDiscovery(self.ctx.meta, **kw)
        self.node = self.discovery.local_node(address=address)
        try:
            self.discovery.register(self.node)
        except Exception:
            pass
        # lease-renewal loop (reference clusters/cluster.rs heartbeat):
        # without it the node's registry entry expires and peers drop it
        if heartbeat_secs > 0:
            def _beat():
                while True:
                    time.sleep(heartbeat_secs)
                    try:
                        self.discovery.heartbeat(self.node.node_id)
                    except Exception:
                        pass
            threading.Thread(target=_beat, daemon=True,
                             name="meta-heartbeat").start()

    def _prepared_for(self, session, user_key: str, sql: str):
        """Bind-once cache for parameterized requests (per user + sql);
        bound to a session view carrying the request's authenticated user
        so privilege checks apply on the generic path."""
        key = (user_key, sql)
        with self._prep_lock:
            ps = self._prep_cache.get(key)
            if ps is None:
                ps = session.prepare(sql)
                self._prep_cache[key] = ps
                if len(self._prep_cache) > 256:
                    self._prep_cache.pop(next(iter(self._prep_cache)))
        return ps

    # ----------------------------------------------------------- handlers
    def _authenticate(self, request):
        """Basic auth against the RBAC user store (reference: the HTTP
        handler's AuthMgr). Resolved PER REQUEST — the shared context is
        never mutated, so concurrent requests can't leak identity. No
        header = root, which only succeeds while root has no password.
        Returns (UserInfo, None) or (None, error_message)."""
        import base64
        hdr = request.headers.get("Authorization")
        if not hdr:
            user, pw = "root", None
        elif not hdr.startswith("Basic "):
            return None, "unsupported authorization scheme"
        else:
            try:
                user, _, pw = base64.b64decode(hdr[6:]).decode().partition(":")
            except Exception as e:
                return None, str(e)
        try:
            return self.ctx.users.authenticate(user, pw or None,
                                               client_ip=request.remote), None
        except Exception as e:
            return None, str(e)

    async def handle_query(self, request):
        from aiohttp import web
        user, auth_err = self._authenticate(request)
        if auth_err is not None:
            return web.json_response(
                {"error": {"code": 1045, "message": auth_err}}, status=401)
        try:
            payload = await request.json()
        except Exception:
            return web.json_response(
                {"error": {"code": 1002, "message": "invalid JSON body"}},
                status=400)
        sql = payload.get("sql")
        if not sql:
            return web.json_response(
                {"error": {"code": 1002, "message": "missing 'sql'"}},
                status=400)
        params = payload.get("params")
        batch = payload.get("params_batch")
        user_key = getattr(user, "name", "root")
        psession = (self.ctx.for_user(user)
                    if (params is not None or batch is not None) else None)
        if batch is not None:
            # batched prepared execution: B parameter sets -> ONE device
            # program for the KNN shape; results come back in one response
            # (no paging), the serving analog of the kernel batch.
            # format=block returns ONE result set with a query_index
            # column (the bulk-serving shape, zero per-query overhead)
            try:
                ps = self._prepared_for(psession, user_key, sql)
                exact = bool(payload.get("exact", True))
                if payload.get("format") == "block":
                    res = await asyncio.get_event_loop().run_in_executor(
                        None, lambda: ps.execute_batch_block(batch, exact))
                    return web.json_response({
                        "schema": [{"name": f.name, "type": str(f.dtype)}
                                   for f in res.fields],
                        "data": [[_json_value(v) for v in row]
                                 for row in res.rows()],
                    })
                outs = await asyncio.get_event_loop().run_in_executor(
                    None, lambda: ps.execute_batch(batch, exact))
                return web.json_response({
                    "schema": [{"name": f.name, "type": str(f.dtype)}
                               for f in outs[0].fields] if outs else [],
                    "results": [[[_json_value(v) for v in row]
                                 for row in r.rows()] for r in outs],
                })
            except DatabendError as e:
                return web.json_response(
                    {"error": {"code": getattr(e, "code", 1000),
                               "message": str(e)}}, status=400)
        prepared = None
        if params is not None:
            try:
                prepared = self._prepared_for(psession, user_key, sql)
            except DatabendError as e:
                return web.json_response(
                    {"error": {"code": getattr(e, "code", 1000),
                               "message": str(e)}}, status=400)
        q = HttpQuery(uuid.uuid4().hex, sql, params, prepared)
        with self._lock:
            self.queries[q.id] = q
            self._gc_locked()
        # one worker thread per query; the engine is thread-safe per-session
        # for read paths and serializes commits via OCC. Each request runs
        # on a session view bound to ITS authenticated user, gated by the
        # admission queue.
        session = self.ctx.for_user(user)

        def run_admitted():
            try:
                self._queue.acquire()
            except Exception as e:
                q.state = "Failed"
                q.error = {"code": 2504, "message": str(e)}
                return
            try:
                q.run(session)
            finally:
                self._queue.release()

        await asyncio.get_event_loop().run_in_executor(None, run_admitted)
        return web.json_response(q.page_response(0))

    async def handle_page(self, request):
        from aiohttp import web
        q = self.queries.get(request.match_info["qid"])
        if q is None:
            return web.json_response(
                {"error": {"code": 1003, "message": "query not found"}},
                status=404)
        try:
            page_no = int(request.match_info["page"])
        except ValueError:
            return web.json_response(
                {"error": {"code": 1002, "message": "bad page"}}, status=400)
        return web.json_response(q.page_response(page_no))

    async def handle_final(self, request):
        from aiohttp import web
        q = self.queries.pop(request.match_info["qid"], None)
        return web.json_response({"id": getattr(q, "id", None),
                                  "state": getattr(q, "state", "Unknown")})

    async def handle_kill(self, request):
        from aiohttp import web
        q = self.queries.get(request.match_info["qid"])
        if q is not None and q.state in ("Starting", "Running"):
            q.state = "Failed"
            q.error = {"code": 1004, "message": "killed"}
        return web.json_response({"id": getattr(q, "id", None),
                                  "state": getattr(q, "state", "Unknown")})

    async def handle_health(self, request):
        from aiohttp import web
        return web.json_response({"status": "ok"})

    async def handle_metrics(self, request):
        from aiohttp import web
        from ...utils.metrics import METRICS
        return web.Response(text=METRICS.prometheus_text(),
                            content_type="text/plain")

    def _gc_locked(self) -> None:
        done = [qid for qid, q in self.queries.items()
                if q.state in ("Succeeded", "Failed")]
        excess = len(done) - self._max_finished
        if excess > 0:
            done.sort(key=lambda qid: self.queries[qid].finished_at or 0)
            for qid in done[:excess]:
                del self.queries[qid]

    # ------------------------------------------------------------- admin
    # (reference: the AdminService HTTP API, src/meta/admin +
    # entry.rs:217 — operational introspection, no SQL round trip)
    async def handle_admin_settings(self, request):
        from aiohttp import web
        return web.json_response(
            {name: str(val) for name, val, _, _ in self.ctx.settings.all()})

    async def handle_admin_cluster(self, request):
        from aiohttp import web
        nodes = [n.to_dict() for n in self.discovery.list_nodes()]
        return web.json_response({"nodes": nodes,
                                  "self": self.node.node_id})

    async def handle_admin_processes(self, request):
        from aiohttp import web
        out = [{"id": q.id, "state": q.state, "sql": q.sql[:512]}
               for q in list(self.queries.values())]
        return web.json_response({"processes": out})

    async def handle_admin_tables(self, request):
        from aiohttp import web
        out = []
        for d in self.ctx.catalog.list_databases():
            for info in self.ctx.catalog.list_tables(d.name):
                out.append({"database": d.name, "name": info.name,
                            "engine": info.engine})
        return web.json_response({"tables": out})

    async def handle_admin_flamegraph(self, request):
        """On-demand process-wide flamegraph: sample every live thread
        for ``?seconds=`` (default 2, max 30) and return the SVG inline.
        Reference analog: the on-demand perf capture in
        src/common/base/src/runtime/perf/query_perf.rs."""
        import asyncio

        from aiohttp import web

        from ...utils.perf import SamplingProfiler, render_flamegraph_svg
        try:
            seconds = min(30.0, max(0.1, float(
                request.query.get("seconds", "2"))))
        except ValueError:
            seconds = 2.0
        prof = SamplingProfiler().start()
        await asyncio.sleep(seconds)
        prof.stop()
        return web.Response(text=render_flamegraph_svg(prof.folded),
                            content_type="image/svg+xml")

    # --------------------------------------------------------------- app
    def make_app(self):
        from aiohttp import web
        app = web.Application(client_max_size=64 * 1024 * 1024)
        app.router.add_post("/v1/query", self.handle_query)
        app.router.add_post("/v1/query/", self.handle_query)
        app.router.add_get("/v1/query/{qid}/page/{page}", self.handle_page)
        app.router.add_post("/v1/query/{qid}/final", self.handle_final)
        app.router.add_get("/v1/query/{qid}/final", self.handle_final)
        app.router.add_post("/v1/query/{qid}/kill", self.handle_kill)
        app.router.add_get("/v1/health", self.handle_health)
        app.router.add_get("/v1/metrics", self.handle_metrics)
        app.router.add_get("/v1/admin/settings", self.handle_admin_settings)
        app.router.add_get("/v1/admin/cluster", self.handle_admin_cluster)
        app.router.add_get("/v1/admin/processes", self.handle_admin_processes)
        app.router.add_get("/v1/admin/tables", self.handle_admin_tables)
        app.router.add_get("/v1/admin/flamegraph",
                           self.handle_admin_flamegraph)
        return app

    def run(self, host: str = "127.0.0.1", port: int = 8124):  # pragma: no cover
        from aiohttp import web
        web.run_app(self.make_app(), host=host, port=port)


def main():  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(description="databend_tpu query server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8124)
    p.add_argument("--data-root", default=".databend_tpu")
    p.add_argument("--meta-endpoint", default=None,
                   help="remote meta service (http://host:port)")
    p.add_argument("--heartbeat-secs", type=float, default=0.0)
    p.add_argument("--lease-ttl-secs", type=float, default=None)
    a = p.parse_args()
    QueryServer(data_root=a.data_root, address=f"{a.host}:{a.port}",
                meta_endpoint=a.meta_endpoint,
                heartbeat_secs=a.heartbeat_secs,
                lease_ttl_secs=a.lease_ttl_secs).run(a.host, a.port)


if __name__ == "__main__":  # pragma: no cover
    main()
