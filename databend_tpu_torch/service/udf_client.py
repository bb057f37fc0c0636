"""External UDF-server client (Arrow Flight do_exchange).

Reference: Databend's UDF server protocol — `CREATE FUNCTION f (INT)
RETURNS INT LANGUAGE python HANDLER='h' ADDRESS='...'` registers a
function whose evaluation ships argument record batches to an external
Arrow Flight server and reads result batches back (reference:
tests/sqllogictests/suites/udf_server/, src/query/expression UDF
support). The wire shape: FlightDescriptor path = [handler]; the client
do_exchange-streams one batch of argument columns and reads one batch
holding a single result column.

Registration is lazy and per-process: external UDFs load from the meta
KV alongside lambda UDFs; the binder resolves them through the global
scalar registry like any built-in.
"""

from __future__ import annotations

from typing import Dict, List

from ..errors import SemanticError, UDFServerError  # noqa: F401
from ..expression import Column
from ..expression.functions.registry import ScalarFunction, registry
from ..types.datatype import parse_type_name

# handler registration bookkeeping: name -> meta dict we registered for,
# so re-registration after CREATE OR REPLACE picks up new options
_REGISTERED: Dict[str, dict] = {}

_CLIENTS: Dict[str, object] = {}


def _client(address: str):
    import pyarrow.flight as fl
    cli = _CLIENTS.get(address)
    if cli is None:
        loc = address
        if "://" not in loc:
            loc = f"grpc://{loc}"
        cli = fl.connect(loc)
        _CLIENTS[address] = cli
    return cli


def call_external_udf(meta: dict, arg_cols: List[Column]) -> Column:
    """One do_exchange round trip: args batch out, result batch in."""
    import pyarrow as pa
    import pyarrow.flight as fl

    from ..storage.fuse.block_io import _from_arrow_array, block_to_arrow
    from ..expression import DataBlock
    names = [f"a{i}" for i in range(len(arg_cols))]
    table = block_to_arrow(DataBlock(names, list(arg_cols)))
    desc = fl.FlightDescriptor.for_path(meta["handler"])
    ret_dtype = parse_type_name(meta["return_type"])
    try:
        writer, reader = _client(meta["address"]).do_exchange(desc)
        with writer:
            writer.begin(table.schema)
            for batch in table.to_batches(max_chunksize=65536):
                writer.write_batch(batch)
            writer.done_writing()
            chunks = [c.data for c in reader]
    except fl.FlightError as e:
        raise UDFServerError(
            f"UDF server {meta['address']!r} failed for "
            f"{meta['handler']!r}: {e}") from None
    if not chunks:
        raise UDFServerError(
            f"UDF server returned no data for {meta['handler']!r}")
    out = pa.Table.from_batches(chunks)
    if out.num_columns != 1:
        raise UDFServerError(
            f"UDF server returned {out.num_columns} columns, expected 1")
    return _from_arrow_array(out.column(0), ret_dtype.wrap_nullable())


def register_external_udf(name: str, meta: dict) -> None:
    """Expose the external UDF through the scalar registry (idempotent;
    re-registers when the definition changed)."""
    key = name.lower()
    if _REGISTERED.get(key) == meta:
        return
    arg_types = [parse_type_name(t) for t in meta.get("arg_types", [])]
    ret = parse_type_name(meta["return_type"])

    def resolve(got_types):
        if len(got_types) != len(arg_types):
            raise SemanticError(
                f"{name} expects {len(arg_types)} args, got {len(got_types)}")
        return ret

    def kernel(columns, validities, arg_types=None, n_rows=0):
        cols = []
        for payload, validity, dt in zip(columns, validities, arg_types):
            cols.append(Column(dt.remove_nullable(), payload, validity))
        out = call_external_udf(meta, cols)
        return out.data, out.validity

    registry.register(ScalarFunction(key, resolve, kernel,
                                     null_policy="custom"))
    _REGISTERED[key] = dict(meta)


def unregister_external_udf(name: str) -> None:
    key = name.lower()
    if key in _REGISTERED:
        _REGISTERED.pop(key, None)
        registry._funcs.pop(key, None)
