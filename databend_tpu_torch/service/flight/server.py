"""Arrow Flight SQL server.

Reference analog: the FlightSQL handler (src/binaries/query/entry.rs:233)
and Arrow Flight v1 exchange serialization (servers/flight/v1/exchange/
serde/exchange_serializer.rs:19-26) — queries in, Arrow record batches out.

Speaks BOTH protocols:

* **FlightSQL** (what ADBC/JDBC drivers send): protobuf commands from
  `arrow.flight.protocol.sql` wrapped in `google.protobuf.Any` inside the
  FlightDescriptor — `CommandStatementQuery`, `CommandGetCatalogs`,
  `CommandGetDbSchemas`, `CommandGetTables`,
  `Action{Create,Close}PreparedStatement`, `CommandPreparedStatementQuery`
  with parameter binding via DoPut, and `CommandStatementUpdate` through
  DoPut (codec: flightsql.py).
* **command=SQL fast path** (legacy): descriptor command / ticket is the
  raw UTF-8 SQL text.

    import pyarrow.flight as fl
    c = fl.connect("grpc://127.0.0.1:8900")
    info = c.get_flight_info(fl.FlightDescriptor.for_command(b"SELECT 1"))
    table = c.do_get(info.endpoints[0].ticket).read_all()
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional

import pyarrow as pa
import pyarrow.flight as fl

from ...errors import DatabendError
from ..session import SessionContext
from . import flightsql as fsql


def _schema_bytes(schema: pa.Schema) -> bytes:
    """Arrow IPC-serialized schema (what FlightSQL results carry)."""
    return schema.serialize().to_pybytes()


class FlightSQLServer(fl.FlightServerBase):
    def __init__(self, data_root: str = ".databend_tpu",
                 location: str = "grpc://127.0.0.1:0",
                 max_running_queries: int = 0):
        super().__init__(location)
        self.ctx = SessionContext(data_root=data_root)
        # admission control instead of a global query lock: reads run
        # concurrently on per-request session views (identity/db isolated);
        # commits serialize via snapshot OCC (reference QueriesQueueManager)
        from ...utils.memstat import QueryQueue
        if not max_running_queries:
            try:
                max_running_queries = int(
                    self.ctx.settings.get("max_running_queries") or 0)
            except Exception:
                max_running_queries = 0
        self._queue = QueryQueue(max_running_queries)
        self._lock = threading.Lock()
        self._results: Dict[bytes, pa.Table] = {}   # ticket handle -> table
        self._prepared: Dict[bytes, dict] = {}      # stmt handle -> entry

    def _run(self, sql: str) -> pa.Table:
        from ...storage.fuse.block_io import block_to_arrow
        self._queue.acquire()
        try:
            session = self.ctx.for_user(self.ctx.current_user)
            res = session.sql(sql)
        except DatabendError as e:
            raise fl.FlightServerError(str(e))
        finally:
            self._queue.release()
        return block_to_arrow(res.block)

    # ------------------------------------------------------ result caching
    def _stash(self, table: pa.Table) -> bytes:
        handle = uuid.uuid4().hex.encode()
        with self._lock:
            self._results[handle] = table
            while len(self._results) > 64:
                self._results.pop(next(iter(self._results)))
        return handle

    def _info(self, descriptor, table: pa.Table) -> fl.FlightInfo:
        ticket = fl.Ticket(fsql.ticket_statement_query(self._stash(table)))
        endpoint = fl.FlightEndpoint(ticket, [])
        return fl.FlightInfo(table.schema, descriptor, [endpoint],
                             table.num_rows, -1)

    # --------------------------------------------------- catalog listings
    def _catalogs_table(self) -> pa.Table:
        return pa.table({"catalog_name": pa.array(["default"], pa.utf8())})

    def _db_schemas_table(self, pattern: Optional[str]) -> pa.Table:
        import fnmatch
        names = [d.name for d in self.ctx.catalog.list_databases()]
        if pattern:
            # FlightSQL patterns use SQL LIKE syntax (% and _)
            pat = pattern.replace("%", "*").replace("_", "?")
            names = [n for n in names if fnmatch.fnmatch(n, pat)]
        return pa.table({
            "catalog_name": pa.array(["default"] * len(names), pa.utf8()),
            "db_schema_name": pa.array(names, pa.utf8())})

    def _tables_table(self, req: dict) -> pa.Table:
        import fnmatch
        from ...storage.fuse.block_io import block_to_arrow  # noqa: F401
        rows = []
        dbs = [d.name for d in self.ctx.catalog.list_databases()]
        if req.get("db_schema_filter_pattern"):
            pat = req["db_schema_filter_pattern"].replace(
                "%", "*").replace("_", "?")
            dbs = [d for d in dbs if fnmatch.fnmatch(d, pat)]
        tpat = req.get("table_name_filter_pattern")
        tpat = tpat.replace("%", "*").replace("_", "?") if tpat else None
        for db in dbs:
            for t in self.ctx.catalog.list_tables(db):
                if tpat and not fnmatch.fnmatch(t.name, tpat):
                    continue
                rows.append((db, t.name, t))
        cols = {
            "catalog_name": pa.array(["default"] * len(rows), pa.utf8()),
            "db_schema_name": pa.array([r[0] for r in rows], pa.utf8()),
            "table_name": pa.array([r[1] for r in rows], pa.utf8()),
            "table_type": pa.array(["TABLE"] * len(rows), pa.utf8()),
        }
        if req.get("include_schema"):
            from ...expression import DataBlock
            from ...pipeline.executor import _empty_column
            from ...storage.fuse.block_io import block_to_arrow
            blobs = []
            for _, _, t in rows:
                try:
                    blk = DataBlock(
                        [f.name for f in t.schema.fields],
                        [_empty_column(f.dtype) for f in t.schema.fields], 0)
                    blobs.append(_schema_bytes(block_to_arrow(blk).schema))
                except Exception:
                    blobs.append(b"")
            cols["table_schema"] = pa.array(blobs, pa.binary())
        return pa.table(cols)

    # -------------------------------------------------------------- flight
    def get_flight_info(self, context, descriptor):
        cmd = descriptor.command or b""
        parsed = fsql.unpack_any(cmd)
        if parsed is None:
            # legacy: the command IS the SQL text
            sql = cmd.decode("utf-8")
            table = self._run(sql)
            endpoint = fl.FlightEndpoint(fl.Ticket(sql.encode()), [])
            return fl.FlightInfo(table.schema, descriptor, [endpoint],
                                 table.num_rows, -1)
        kind, payload = parsed
        if kind == "CommandStatementQuery":
            return self._info(descriptor,
                              self._run(fsql.parse_statement_query(payload)))
        if kind == "CommandGetCatalogs":
            return self._info(descriptor, self._catalogs_table())
        if kind == "CommandGetDbSchemas":
            _, pat = fsql.parse_get_db_schemas(payload)
            return self._info(descriptor, self._db_schemas_table(pat))
        if kind == "CommandGetTables":
            return self._info(descriptor,
                              self._tables_table(fsql.parse_get_tables(payload)))
        if kind == "CommandPreparedStatementQuery":
            handle = fsql.parse_prepared_statement_query(payload)
            entry = self._prepared.get(handle)
            if entry is None:
                raise fl.FlightServerError("unknown prepared statement")
            return self._info(descriptor, self._run_prepared(entry))
        raise fl.FlightServerError(f"unsupported FlightSQL command {kind}")

    def _run_prepared(self, entry: dict) -> pa.Table:
        from ...storage.fuse.block_io import block_to_arrow
        ps = entry["stmt"]
        params = entry.get("params") or []
        self._queue.acquire()
        try:
            if ps.param_count == 0:
                return block_to_arrow(ps.execute().block)
            if not params:
                raise fl.FlightServerError(
                    "prepared statement expects parameters; bind via DoPut")
            outs = [ps.execute(*p) for p in params]
            return pa.concat_tables([block_to_arrow(r.block) for r in outs])
        except DatabendError as e:
            raise fl.FlightServerError(str(e))
        finally:
            self._queue.release()

    def do_get(self, context, ticket):
        raw = ticket.ticket
        parsed = fsql.unpack_any(raw)
        if parsed is not None and parsed[0] == "TicketStatementQuery":
            handle = fsql.parse_ticket_statement(parsed[1])
            with self._lock:
                table = self._results.pop(handle, None)
            if table is None:
                raise fl.FlightServerError("unknown or consumed ticket")
            return fl.RecordBatchStream(table)
        table = self._run(raw.decode("utf-8"))
        return fl.RecordBatchStream(table)

    def do_put(self, context, descriptor, reader, writer):
        cmd = descriptor.command or b""
        parsed = fsql.unpack_any(cmd)
        if parsed is None:
            raise fl.FlightServerError("DoPut requires a FlightSQL command")
        kind, payload = parsed
        if kind == "CommandStatementUpdate":
            sql = fsql.parse_statement_query(payload)
            self._queue.acquire()
            try:
                session = self.ctx.for_user(self.ctx.current_user)
                res = session.sql(sql)
                n = res.affected_rows
            except DatabendError as e:
                raise fl.FlightServerError(str(e))
            finally:
                self._queue.release()
            writer.write(pa.py_buffer(fsql.do_put_update_result(int(n))))
            return
        if kind == "CommandPreparedStatementQuery":
            handle = fsql.parse_prepared_statement_query(payload)
            entry = self._prepared.get(handle)
            if entry is None:
                raise fl.FlightServerError("unknown prepared statement")
            # parameter rows: one execution per row, positional columns
            table = reader.read_all()
            params = []
            for i in range(table.num_rows):
                row = []
                for col in table.columns:
                    v = col[i].as_py()
                    row.append(v)
                params.append(tuple(row))
            entry["params"] = params
            return
        raise fl.FlightServerError(f"unsupported DoPut command {kind}")

    def do_action(self, context, action):
        if action.type == "CreatePreparedStatement":
            parsed = fsql.unpack_any(action.body.to_pybytes())
            if parsed is None or parsed[0] != \
                    "ActionCreatePreparedStatementRequest":
                raise fl.FlightServerError("bad CreatePreparedStatement body")
            sql = fsql.parse_create_prepared_request(parsed[1])
            try:
                ps = self.ctx.prepare(sql)
            except DatabendError as e:
                raise fl.FlightServerError(str(e))
            handle = uuid.uuid4().hex.encode()
            self._prepared[handle] = {"stmt": ps}
            return iter([fl.Result(
                fsql.action_create_prepared_result(handle))])
        if action.type == "ClosePreparedStatement":
            parsed = fsql.unpack_any(action.body.to_pybytes())
            if parsed is not None:
                handle = fsql.parse_close_prepared_request(parsed[1])
                self._prepared.pop(handle, None)
            return iter([])
        if action.type == "execute":
            table = self._run(action.body.to_pybytes().decode("utf-8"))
            return iter([fl.Result(str(table.num_rows).encode())])
        if action.type == "health":
            return iter([fl.Result(b"ok")])
        raise fl.FlightServerError(f"unknown action {action.type!r}")


def main():  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(description="databend_tpu Flight SQL server")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--data-root", default=".databend_tpu")
    a = p.parse_args()
    srv = FlightSQLServer(a.data_root, f"grpc://127.0.0.1:{a.port}")
    print(f"flight sql listening on grpc://127.0.0.1:{srv.port}")
    srv.serve()


if __name__ == "__main__":  # pragma: no cover
    main()
