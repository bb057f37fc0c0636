"""MySQL wire protocol server (protocol v10, text resultsets).

Reference analog: the MySQLHandler front end
(src/query/service/src/servers/mysql/ — handshake, COM_QUERY dispatch,
text protocol encoding). Implements the subset every mysql client/driver
needs: v10 handshake (mysql_native_password), COM_QUERY / COM_PING /
COM_INIT_DB / COM_QUIT, CLIENT_PROTOCOL_41 text resultsets with EOF
packets, and ERR packets carrying engine error codes.
"""

from __future__ import annotations

import hashlib
import math
import os
import socket
import socketserver
import struct
import threading
from typing import List, Optional

from ...errors import DatabendError
from ..session import SessionContext

# capability flags
CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8

SERVER_CAPS = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
               | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
               | CLIENT_CONNECT_WITH_DB)

COM_QUIT, COM_INIT_DB, COM_QUERY, COM_PING = 0x01, 0x02, 0x03, 0x0E

MYSQL_TYPE_DOUBLE = 0x05
MYSQL_TYPE_LONGLONG = 0x08
MYSQL_TYPE_VAR_STRING = 0xFD


def _lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def _lenenc_str(s: bytes) -> bytes:
    return _lenenc_int(len(s)) + s


def _cell_text(v) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, float):
        if math.isnan(v):
            return b"NaN"
        return repr(v).encode()
    if isinstance(v, (list, tuple)):
        return ("[" + ",".join(str(x) for x in v) + "]").encode()
    if isinstance(v, bytes):
        return v
    return str(v).encode()


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def read_packet(self) -> bytes:
        hdr = self._read_n(4)
        length = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
        self.seq = (hdr[3] + 1) & 0xFF
        return self._read_n(length)

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def send_packet(self, payload: bytes):
        length = len(payload)
        hdr = bytes([length & 0xFF, (length >> 8) & 0xFF,
                     (length >> 16) & 0xFF, self.seq])
        self.sock.sendall(hdr + payload)
        self.seq = (self.seq + 1) & 0xFF

    # ------------------------------------------------------------- packets
    def send_handshake(self, salt: bytes, conn_id: int):
        p = b"\x0a"                                  # protocol 10
        p += b"databend_tpu-8.0\x00"
        p += struct.pack("<I", conn_id)
        p += salt[:8] + b"\x00"
        p += struct.pack("<H", SERVER_CAPS & 0xFFFF)
        p += bytes([0x21])                           # charset utf8
        p += struct.pack("<H", 2)                    # status
        p += struct.pack("<H", (SERVER_CAPS >> 16) & 0xFFFF)
        p += bytes([21])                             # auth data len
        p += b"\x00" * 10
        p += salt[8:] + b"\x00"
        p += b"mysql_native_password\x00"
        self.seq = 0
        self.send_packet(p)

    def send_ok(self, affected: int = 0):
        self.send_packet(b"\x00" + _lenenc_int(affected) + _lenenc_int(0)
                         + struct.pack("<HH", 2, 0))

    def send_eof(self):
        self.send_packet(b"\xfe" + struct.pack("<HH", 0, 2))

    def send_err(self, code: int, msg: str):
        self.send_packet(b"\xff" + struct.pack("<H", code) + b"#HY000"
                         + msg.encode("utf-8")[:400])


def _native_password(password: str, salt: bytes) -> bytes:
    # SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


class MySQLServer:
    """Threaded MySQL-protocol front end over one engine."""

    def __init__(self, data_root: str = ".databend_tpu",
                 host: str = "127.0.0.1", port: int = 3307):
        self.ctx = SessionContext(data_root=data_root)
        self.host, self.port = host, port
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._conn_id = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Start in a background thread; returns the bound port."""
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._serve_client(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    # ------------------------------------------------------------ protocol
    def _serve_client(self, sock: socket.socket):
        conn = _Conn(sock)
        salt = os.urandom(20)
        self._conn_id += 1
        conn.send_handshake(salt, self._conn_id)
        try:
            resp = conn.read_packet()
        except ConnectionError:
            return
        user, auth, database = self._parse_handshake_response(resp)
        try:
            u = self.ctx.users.get_user(user or "root")
            if u is None:
                raise DatabendError(f"unknown user {user!r}")
            if u.password_sha256 is not None:
                # native-password scramble can't be checked against a
                # sha256 store; accept only matching double-scramble of
                # the stored plaintext is impossible — require empty-auth
                # users over this transport or verify via plaintext
                raise DatabendError(
                    "password login over mysql transport unsupported; "
                    "use the HTTP handler")
        except DatabendError as e:
            conn.send_err(1045, str(e))
            return
        conn.send_ok()
        if database:
            try:
                self.ctx.sql(f"USE {database}")
            except DatabendError:
                pass

        while True:
            try:
                pkt = conn.read_packet()
            except ConnectionError:
                return
            if not pkt:
                return
            cmd, body = pkt[0], pkt[1:]
            conn.seq = 1
            if cmd == COM_QUIT:
                return
            if cmd == COM_PING:
                conn.send_ok()
                continue
            if cmd == COM_INIT_DB:
                try:
                    self.ctx.sql(f"USE {body.decode()}")
                    conn.send_ok()
                except DatabendError as e:
                    conn.send_err(getattr(e, "code", 1064), str(e))
                continue
            if cmd == COM_QUERY:
                self._handle_query(conn, body.decode("utf-8", "replace"))
                continue
            conn.send_err(1047, f"unsupported command {cmd:#x}")

    def _parse_handshake_response(self, resp: bytes):
        # capabilities(4) max_packet(4) charset(1) reserved(23) user\0 ...
        if len(resp) < 32:
            return None, b"", None
        caps = struct.unpack("<I", resp[:4])[0]
        i = 32
        end = resp.index(b"\x00", i)
        user = resp[i:end].decode()
        i = end + 1
        auth = b""
        if caps & CLIENT_SECURE_CONNECTION and i < len(resp):
            alen = resp[i]
            auth = resp[i + 1:i + 1 + alen]
            i += 1 + alen
        database = None
        if caps & CLIENT_CONNECT_WITH_DB and i < len(resp):
            try:
                end = resp.index(b"\x00", i)
                database = resp[i:end].decode() or None
            except ValueError:
                pass
        return user, auth, database

    def _column_def(self, name: str, dtype) -> bytes:
        from ...types import NumberType
        inner = dtype.remove_nullable()
        if isinstance(inner, NumberType) and inner.is_integer():
            ftype, length = MYSQL_TYPE_LONGLONG, 21
        elif isinstance(inner, NumberType):
            ftype, length = MYSQL_TYPE_DOUBLE, 24
        else:
            ftype, length = MYSQL_TYPE_VAR_STRING, 1024
        p = _lenenc_str(b"def") + _lenenc_str(b"") + _lenenc_str(b"")
        p += _lenenc_str(b"") + _lenenc_str(name.encode()) + _lenenc_str(b"")
        p += bytes([0x0c]) + struct.pack("<H", 0x21)
        p += struct.pack("<I", length) + bytes([ftype])
        p += struct.pack("<H", 0) + bytes([0]) + b"\x00\x00"
        return p

    def _handle_query(self, conn: _Conn, sql: str):
        s = sql.strip().rstrip(";")
        low = s.lower()
        # common client session boilerplate -> OK
        if (low.startswith(("set names", "set autocommit", "set session",
                            "set sql_mode", "set character"))
                or low in ("commit", "rollback", "begin", "start transaction")):
            conn.send_ok()
            return
        if low.startswith("select @@"):
            s = "SELECT 1 AS version_comment"
        try:
            res = self.ctx.sql(s)
        except DatabendError as e:
            conn.send_err(min(getattr(e, "code", 1064), 65535), str(e))
            return
        if not res.fields or (res.block.num_rows == 0 and res.affected_rows):
            conn.send_ok(res.affected_rows)
            return
        conn.send_packet(_lenenc_int(len(res.fields)))
        for f in res.fields:
            conn.send_packet(self._column_def(f.name, f.dtype))
        conn.send_eof()
        for row in res.rows():
            p = b""
            for v in row:
                cell = _cell_text(v)
                p += b"\xfb" if cell is None else _lenenc_str(cell)
            conn.send_packet(p)
        conn.send_eof()


def main():  # pragma: no cover
    import argparse
    ap = argparse.ArgumentParser(description="databend_tpu MySQL handler")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=3307)
    ap.add_argument("--data-root", default=".databend_tpu")
    a = ap.parse_args()
    srv = MySQLServer(a.data_root, a.host, a.port)
    srv.start()
    print(f"mysql handler listening on {a.host}:{srv.port}")
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    main()
