"""Minimal Avro Object Container File reader.

The image ships no avro library, so COPY INTO .. FILE_FORMAT=(TYPE=AVRO)
decodes the OCF binary format directly (reference: src/query/formats Avro
field decoders). Supported: null/boolean/int/long/float/double/bytes/
string primitives, records, nullable unions, arrays, maps, enums, fixed;
codecs null + deflate (raw zlib). Logical types decode as their base type
(the cast layer parses date/timestamp strings/ints like the CSV path).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List

from ..errors import BadArguments

MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise BadArguments("truncated avro data")
        self.pos += n
        return out

    def long(self) -> int:
        """zig-zag varint."""
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def _decode(r: _Reader, schema) -> Any:
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):  # union
        idx = r.long()
        if idx < 0 or idx >= len(schema):
            raise BadArguments(f"bad avro union branch {idx}")
        return _decode(r, schema[idx])
    else:
        t = schema["type"]
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) != b"\x00"
    if t in ("int", "long"):
        return r.long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.read(r.long())
    if t == "string":
        return r.read(r.long()).decode("utf-8")
    if t == "record":
        return {f["name"]: _decode(r, f["type"]) for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][r.long()]
    if t == "fixed":
        return r.read(schema["size"])
    if t == "array":
        out = []
        while True:
            n = r.long()
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                n = -n
                r.long()
            for _ in range(n):
                out.append(_decode(r, schema["items"]))
        return out
    if t == "map":
        out = {}
        while True:
            n = r.long()
            if n == 0:
                break
            if n < 0:
                n = -n
                r.long()
            for _ in range(n):
                k = r.read(r.long()).decode("utf-8")
                out[k] = _decode(r, schema["values"])
        return out
    # named-type reference or logical type wrapper
    if isinstance(schema, dict) and "logicalType" in schema:
        return _decode(r, schema["type"])
    raise BadArguments(f"unsupported avro type {t!r}")


def read_avro_records(path: str) -> Iterator[Dict[str, Any]]:
    """Yield records (dicts) from an Avro OCF file."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise BadArguments(f"{path}: not an avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.long()
        for _ in range(n):
            k = r.read(r.long()).decode("utf-8")
            meta[k] = r.read(r.long())
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = r.read(16)
    while not r.at_end():
        count = r.long()
        size = r.long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise BadArguments(f"unsupported avro codec {codec!r}")
        br = _Reader(payload)
        for _ in range(count):
            rec = _decode(br, schema)
            if not isinstance(rec, dict):
                rec = {"value": rec}
            yield rec
        if r.read(16) != sync:
            raise BadArguments("avro sync marker mismatch")


def write_avro_records(path: str, schema: dict,
                       records: List[Dict[str, Any]]) -> None:
    """Tiny OCF writer (tests + COPY INTO location)."""
    import os
    buf = io.BytesIO()

    def wlong(out, v: int):
        v = (v << 1) ^ (v >> 63)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.write(bytes([b | 0x80]))
            else:
                out.write(bytes([b]))
                break

    def wbytes(out, b: bytes):
        wlong(out, len(b))
        out.write(b)

    def enc(out, sch, v):
        if isinstance(sch, list):  # union: null-or-type
            if v is None:
                wlong(out, sch.index("null"))
                return
            idx = next(i for i, s in enumerate(sch) if s != "null")
            wlong(out, idx)
            enc(out, sch[idx], v)
            return
        t = sch if isinstance(sch, str) else sch["type"]
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if v else b"\x00")
        elif t in ("int", "long"):
            wlong(out, int(v))
        elif t == "float":
            out.write(struct.pack("<f", float(v)))
        elif t == "double":
            out.write(struct.pack("<d", float(v)))
        elif t == "string":
            wbytes(out, str(v).encode("utf-8"))
        elif t == "bytes":
            wbytes(out, bytes(v))
        elif t == "record":
            for f in sch["fields"]:
                enc(out, f["type"], v.get(f["name"]))
        elif t == "array":
            if v:
                wlong(out, len(v))
                for item in v:
                    enc(out, sch["items"], item)
            wlong(out, 0)
        else:
            raise BadArguments(f"avro writer: unsupported type {t!r}")

    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null"}
    body = io.BytesIO()
    for rec in records:
        enc(body, schema, rec)
    payload = body.getvalue()
    sync = os.urandom(16)
    buf.write(MAGIC)
    wlong(buf, len(meta))
    for k, v in meta.items():
        wbytes(buf, k.encode())
        wbytes(buf, v)
    wlong(buf, 0)
    buf.write(sync)
    wlong(buf, len(records))
    wlong(buf, len(payload))
    buf.write(payload)
    buf.write(sync)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
