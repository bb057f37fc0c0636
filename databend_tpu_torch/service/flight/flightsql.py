"""Arrow FlightSQL protocol messages — minimal wire codec.

The reference serves real FlightSQL (src/binaries/query/entry.rs:233), so
ADBC/JDBC drivers connect by wrapping protobuf commands from
`arrow/flight/protocol/sql/FlightSql.proto` in a `google.protobuf.Any`
inside the FlightDescriptor. The messages this engine needs contain only
string/bytes/bool scalar fields, so rather than vendoring generated
stubs we encode/decode the handful of messages by hand (proto3 wire
format: tag = field_number << 3 | wire_type; wire type 2 =
length-delimited, 0 = varint). This keeps the dependency surface at
pyarrow only and the bytes are identical to protoc's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_PREFIX = "type.googleapis.com/arrow.flight.protocol.sql."


# ------------------------------------------------------------ wire helpers
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _parse(buf: bytes) -> Dict[int, list]:
    """proto3 message -> {field_number: [raw values]} (types 0 and 2)."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(num, []).append(val)
    return out


# ------------------------------------------------------------------- Any
def pack_any(type_name: str, payload: bytes) -> bytes:
    """google.protobuf.Any{type_url=1, value=2} wrapping a FlightSQL msg."""
    return (_field_bytes(1, (_PREFIX + type_name).encode())
            + _field_bytes(2, payload))


def unpack_any(buf: bytes) -> Optional[Tuple[str, bytes]]:
    """Returns (short type name, payload) or None when not a FlightSQL Any."""
    try:
        f = _parse(buf)
    except Exception:
        return None
    urls = f.get(1)
    if not urls:
        return None
    url = urls[0].decode("utf-8", "replace")
    if not url.startswith(_PREFIX):
        return None
    vals = f.get(2, [b""])
    return url[len(_PREFIX):], vals[0]


# --------------------------------------------------------------- messages
def cmd_statement_query(query: str) -> bytes:
    return pack_any("CommandStatementQuery",
                    _field_bytes(1, query.encode()))


def parse_statement_query(payload: bytes) -> str:
    return _parse(payload).get(1, [b""])[0].decode()


def cmd_statement_update(query: str) -> bytes:
    return pack_any("CommandStatementUpdate",
                    _field_bytes(1, query.encode()))


def ticket_statement_query(handle: bytes) -> bytes:
    return pack_any("TicketStatementQuery", _field_bytes(1, handle))


def parse_ticket_statement(payload: bytes) -> bytes:
    return _parse(payload).get(1, [b""])[0]


def cmd_get_catalogs() -> bytes:
    return pack_any("CommandGetCatalogs", b"")


def cmd_get_db_schemas(catalog: Optional[str] = None,
                       filter_pattern: Optional[str] = None) -> bytes:
    body = b""
    if catalog is not None:
        body += _field_bytes(1, catalog.encode())
    if filter_pattern is not None:
        body += _field_bytes(2, filter_pattern.encode())
    return pack_any("CommandGetDbSchemas", body)


def parse_get_db_schemas(payload: bytes) -> Tuple[Optional[str],
                                                  Optional[str]]:
    f = _parse(payload)
    cat = f.get(1, [None])[0]
    pat = f.get(2, [None])[0]
    return (cat.decode() if cat is not None else None,
            pat.decode() if pat is not None else None)


def cmd_get_tables(catalog: Optional[str] = None,
                   db_schema_filter_pattern: Optional[str] = None,
                   table_name_filter_pattern: Optional[str] = None,
                   table_types: Optional[List[str]] = None,
                   include_schema: bool = False) -> bytes:
    body = b""
    if catalog is not None:
        body += _field_bytes(1, catalog.encode())
    if db_schema_filter_pattern is not None:
        body += _field_bytes(2, db_schema_filter_pattern.encode())
    if table_name_filter_pattern is not None:
        body += _field_bytes(3, table_name_filter_pattern.encode())
    for t in table_types or []:
        body += _field_bytes(4, t.encode())
    if include_schema:
        body += _field_varint(5, 1)
    return pack_any("CommandGetTables", body)


def parse_get_tables(payload: bytes) -> dict:
    f = _parse(payload)
    def s(num):
        v = f.get(num, [None])[0]
        return v.decode() if v is not None else None
    return {"catalog": s(1), "db_schema_filter_pattern": s(2),
            "table_name_filter_pattern": s(3),
            "table_types": [v.decode() for v in f.get(4, [])],
            "include_schema": bool(f.get(5, [0])[0])}


def action_create_prepared_request(query: str) -> bytes:
    return pack_any("ActionCreatePreparedStatementRequest",
                    _field_bytes(1, query.encode()))


def parse_create_prepared_request(payload: bytes) -> str:
    return _parse(payload).get(1, [b""])[0].decode()


def action_create_prepared_result(handle: bytes,
                                  dataset_schema: bytes = b"",
                                  parameter_schema: bytes = b"") -> bytes:
    body = _field_bytes(1, handle)
    if dataset_schema:
        body += _field_bytes(2, dataset_schema)
    if parameter_schema:
        body += _field_bytes(3, parameter_schema)
    return pack_any("ActionCreatePreparedStatementResult", body)


def parse_create_prepared_result(payload: bytes) -> Tuple[bytes, bytes,
                                                          bytes]:
    f = _parse(payload)
    return (f.get(1, [b""])[0], f.get(2, [b""])[0], f.get(3, [b""])[0])


def action_close_prepared_request(handle: bytes) -> bytes:
    return pack_any("ActionClosePreparedStatementRequest",
                    _field_bytes(1, handle))


def parse_close_prepared_request(payload: bytes) -> bytes:
    return _parse(payload).get(1, [b""])[0]


def cmd_prepared_statement_query(handle: bytes) -> bytes:
    return pack_any("CommandPreparedStatementQuery",
                    _field_bytes(1, handle))


def parse_prepared_statement_query(payload: bytes) -> bytes:
    return _parse(payload).get(1, [b""])[0]


def do_put_update_result(record_count: int) -> bytes:
    """DoPutUpdateResult{int64 record_count = 1} (NOT Any-wrapped)."""
    return _field_varint(1, record_count)


def parse_do_put_update_result(buf: bytes) -> int:
    return int(_parse(buf).get(1, [0])[0])
