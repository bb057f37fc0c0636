"""In-process Arrow Flight UDF server (the databend-udf server analog).

The reference ships a python UDF-server example exercised by
`tests/sqllogictests/suites/udf_server/`; this is the equivalent for this
engine: register python callables by handler name, serve them over
Arrow Flight do_exchange (descriptor path = [handler]; argument batches
in, one result column out). Used by tests and usable standalone:

    srv = UdfServer({"gcd": (lambda a, b: np.gcd(a, b))})
    srv.start()   # -> "grpc://127.0.0.1:<port>"
    ctx.sql(f"CREATE FUNCTION gcd (INT, INT) RETURNS INT "
            f"LANGUAGE python HANDLER='gcd' ADDRESS='{srv.address}'")
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl


class UdfServer(fl.FlightServerBase):
    def __init__(self, handlers: Dict[str, Callable],
                 location: str = "grpc://127.0.0.1:0"):
        super().__init__(location)
        self.handlers = dict(handlers)

    @property
    def address(self) -> str:
        return f"grpc://127.0.0.1:{self.port}"

    def do_exchange(self, context, descriptor, reader, writer):
        if not descriptor.path:
            raise fl.FlightServerError("missing handler path")
        name = descriptor.path[0].decode() if isinstance(
            descriptor.path[0], bytes) else descriptor.path[0]
        fn = self.handlers.get(name)
        if fn is None:
            raise fl.FlightServerError(f"unknown handler {name!r}")
        table = reader.read_all()
        args = [np.asarray(col.to_pandas()) for col in table.columns]
        try:
            out = fn(*args)
        except Exception as e:
            raise fl.FlightServerError(f"{name} raised: {e}")
        arr = pa.array(out)
        result = pa.table({"result": arr})
        writer.begin(result.schema)
        writer.write_table(result)
