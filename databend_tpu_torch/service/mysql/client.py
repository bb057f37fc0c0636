"""Minimal MySQL wire-protocol CLIENT (protocol v10, text resultsets).

Reference analog: the MySQL dictionary source connector
(src/query/service/src/interpreters/ dictionary lookups use sqlx's MySQL
client). This is the consumer side of the same protocol our
service/mysql/server.py speaks: v10 handshake + mysql_native_password,
COM_QUERY with CLIENT_PROTOCOL_41 text resultsets. Enough for the
dictionary MYSQL source to load key->attribute mappings from any
MySQL-compatible endpoint (including another databend_tpu node's MySQL
front end — how the tests exercise it without network egress).
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import List, Optional, Tuple

from ...errors import BadArguments

CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8

COM_QUIT, COM_QUERY = 0x01, 0x03


def _native_password(password: str, salt: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


class MySQLClient:
    """One connection; `query()` returns (columns, rows-of-str|None)."""

    def __init__(self, host: str, port: int, user: str = "root",
                 password: str = "", database: str = "",
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.seq = 0
        self._handshake(user, password, database)

    # ------------------------------------------------------------ packets
    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def _read_packet(self) -> bytes:
        hdr = self._read_n(4)
        length = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
        self.seq = (hdr[3] + 1) & 0xFF
        return self._read_n(length)

    def _send_packet(self, payload: bytes):
        n = len(payload)
        self.sock.sendall(bytes([n & 0xFF, (n >> 8) & 0xFF,
                                 (n >> 16) & 0xFF, self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    # ---------------------------------------------------------- handshake
    def _handshake(self, user: str, password: str, database: str):
        p = self._read_packet()
        if p[:1] == b"\xff":
            raise BadArguments(self._err_text(p))
        if p[0] != 0x0A:
            raise BadArguments(f"unsupported protocol {p[0]}")
        i = 1
        i = p.index(b"\x00", i) + 1            # server version
        i += 4                                  # connection id
        salt = p[i:i + 8]
        i += 8 + 1                              # salt part 1 + filler
        i += 2 + 1 + 2 + 2                      # caps_lo, charset, status, caps_hi
        auth_len = p[i]
        i += 1 + 10                             # auth data len + reserved
        salt2_len = max(13, auth_len - 8) - 1
        salt += p[i:i + salt2_len].rstrip(b"\x00")
        caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH)
        if database:
            caps |= CLIENT_CONNECT_WITH_DB
        auth = _native_password(password, salt[:20])
        resp = struct.pack("<IIB", caps, 1 << 24, 0x21) + b"\x00" * 23
        resp += user.encode() + b"\x00"
        resp += bytes([len(auth)]) + auth
        if database:
            resp += database.encode() + b"\x00"
        resp += b"mysql_native_password\x00"
        self._send_packet(resp)
        ok = self._read_packet()
        if ok[:1] == b"\xff":
            raise BadArguments("mysql auth failed: " + self._err_text(ok))

    @staticmethod
    def _err_text(p: bytes) -> str:
        # ERR: 0xff code[2] '#' sqlstate[5] message
        msg = p[3:]
        if msg[:1] == b"#":
            msg = msg[6:]
        return msg.decode("utf-8", "replace")

    # -------------------------------------------------------------- query
    def query(self, sql: str) -> Tuple[List[str],
                                       List[List[Optional[str]]]]:
        self.seq = 0
        self._send_packet(bytes([COM_QUERY]) + sql.encode())
        p = self._read_packet()
        if p[:1] == b"\xff":
            raise BadArguments("mysql query failed: " + self._err_text(p))
        if p[:1] == b"\x00":
            return [], []                       # OK packet, no resultset
        ncols, _ = self._lenenc(p, 0)
        cols = []
        for _ in range(ncols):
            cp = self._read_packet()
            cols.append(self._column_name(cp))
        self._read_packet()                     # EOF after columns
        rows: List[List[Optional[str]]] = []
        while True:
            rp = self._read_packet()
            if rp[:1] == b"\xfe" and len(rp) < 9:
                break                           # EOF after rows
            if rp[:1] == b"\xff":
                raise BadArguments("mysql row error: "
                                   + self._err_text(rp))
            row: List[Optional[str]] = []
            i = 0
            while i < len(rp):
                if rp[i] == 0xFB:               # NULL
                    row.append(None)
                    i += 1
                    continue
                n, i = self._lenenc(rp, i)
                row.append(rp[i:i + n].decode("utf-8", "replace"))
                i += n
            rows.append(row)
        return cols, rows

    @staticmethod
    def _lenenc(p: bytes, i: int) -> Tuple[int, int]:
        b0 = p[i]
        if b0 < 0xFB:
            return b0, i + 1
        if b0 == 0xFC:
            return p[i + 1] | (p[i + 2] << 8), i + 3
        if b0 == 0xFD:
            return p[i + 1] | (p[i + 2] << 8) | (p[i + 3] << 16), i + 4
        return struct.unpack("<Q", p[i + 1:i + 9])[0], i + 9

    @classmethod
    def _column_name(cls, p: bytes) -> str:
        # catalog, schema, table, org_table, name, org_name (lenenc strs)
        i = 0
        out = ""
        for field_idx in range(5):
            n, i = cls._lenenc(p, i)
            s = p[i:i + n]
            i += n
            if field_idx == 4:
                out = s.decode("utf-8", "replace")
        return out

    def close(self):
        try:
            self.seq = 0
            self._send_packet(bytes([COM_QUIT]))
        except Exception:
            pass
        self.sock.close()
