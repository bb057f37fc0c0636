"""Minimal RESP (Redis protocol) client for the dictionary REDIS source.

Reference analog: the Redis dictionary connector (redis key -> value
string lookups during dict_get). Speaks RESP2: inline command arrays
out, simple/bulk/array/integer replies in. Supports the three commands
the dictionary loader needs: GET, MGET, and cursor SCAN.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Tuple

from ..errors import BadArguments


class RedisClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""

    # ------------------------------------------------------------- protocol
    def _cmd(self, *args: str):
        out = b"*" + str(len(args)).encode() + b"\r\n"
        for a in args:
            b = a.encode() if isinstance(a, str) else a
            out += b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n"
        self.sock.sendall(out)
        return self._reply()

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis server closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def _reply(self):
        line = self._line()
        t, body = line[:1], line[1:]
        if t == b"+":
            return body.decode()
        if t == b"-":
            raise BadArguments("redis error: " + body.decode())
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n == -1:
                return None
            return self._exact(n).decode("utf-8", "replace")
        if t == b"*":
            n = int(body)
            if n == -1:
                return None
            return [self._reply() for _ in range(n)]
        raise BadArguments(f"unexpected redis reply type {t!r}")

    # ------------------------------------------------------------- commands
    def get(self, key: str) -> Optional[str]:
        return self._cmd("GET", key)

    def mget(self, keys: List[str]) -> List[Optional[str]]:
        if not keys:
            return []
        return self._cmd("MGET", *keys)

    def scan_all(self, match: str = "*", count: int = 1000) -> List[str]:
        """Full keyspace enumeration via cursor SCAN."""
        keys: List[str] = []
        cursor = "0"
        while True:
            cur, batch = self._cmd("SCAN", cursor, "MATCH", match,
                                   "COUNT", str(count))
            keys.extend(batch or [])
            cursor = cur
            if cursor == "0":
                return keys

    def close(self):
        self.sock.close()
