"""Metadata KV store with OCC semantics.

TPU-native stand-in for the reference's raft-replicated meta service
(reference: src/meta/ — the query side talks to it through a typed KV API,
src/meta/api/src/api_impl/). Single-process deployments use the embedded
sqlite backend (crash-safe, atomic compare-and-swap on a per-key sequence
number — the equivalent of `MetaStore::Local`, src/meta/store/src/local.rs);
an in-memory backend serves tests. The sequence number drives snapshot-commit
OCC exactly like `TableVersionMismatched` retries in the reference
(sink_commit.rs:791-808).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..errors import TableVersionMismatched


class MetaStore:
    """Key-value store: every key carries a monotonically increasing seq.

    ``upsert(key, value, expected_seq)``: expected_seq None = unconditional;
    0 = key must not exist; >0 = CAS on that sequence.
    """

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.RLock()
        self._path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # timeout installs sqlite's busy handler so contention from
            # other processes degrades to latency, not "database is
            # locked" errors (observed under external CPU load in
            # tests/test_concurrency_stress.py)
            self._db = sqlite3.connect(path, check_same_thread=False,
                                       timeout=30.0)
            self._db.execute("PRAGMA busy_timeout=30000")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, seq INTEGER, value TEXT)")
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.commit()
            self._mem: Optional[Dict[str, Tuple[int, str]]] = None
        else:
            self._db = None
            self._mem = {}

    # ------------------------------------------------------------------ reads
    def get(self, key: str) -> Tuple[Optional[Any], int]:
        """Returns (value, seq); (None, 0) when absent."""
        with self._lock:
            if self._mem is not None:
                if key in self._mem:
                    seq, raw = self._mem[key]
                    return json.loads(raw), seq
                return None, 0
            row = self._db.execute("SELECT seq, value FROM kv WHERE key=?", (key,)).fetchone()
            if row is None:
                return None, 0
            return json.loads(row[1]), row[0]

    def list_prefix(self, prefix: str) -> List[Tuple[str, Any, int]]:
        with self._lock:
            if self._mem is not None:
                return sorted(
                    (k, json.loads(raw), seq)
                    for k, (seq, raw) in self._mem.items() if k.startswith(prefix))
            rows = self._db.execute(
                "SELECT key, value, seq FROM kv WHERE key >= ? AND key < ? ORDER BY key",
                (prefix, prefix + "￿")).fetchall()
            return [(k, json.loads(v), seq) for k, v, seq in rows]

    # ----------------------------------------------------------------- writes
    def upsert(self, key: str, value: Any, expected_seq: Optional[int] = None) -> int:
        """CAS must hold across *instances* too: several sessions (or
        processes) can open the same sqlite file, so the check-and-set is
        one guarded SQL statement under an immediate transaction, not a
        read-then-write under the in-process lock (a lost update here
        silently drops a committed snapshot — found by
        tests/test_concurrency_stress.py)."""
        raw = json.dumps(value)
        with self._lock:
            if self._mem is not None:
                _, cur_seq = self.get(key)
                if expected_seq is not None and cur_seq != expected_seq:
                    raise TableVersionMismatched(
                        f"meta CAS failed on {key!r}: expected seq "
                        f"{expected_seq}, found {cur_seq}")
                new_seq = cur_seq + 1
                self._mem[key] = (new_seq, raw)
                return new_seq
            for _ in range(64):  # sqlite busy retries under contention
                try:
                    self._db.execute("BEGIN IMMEDIATE")
                except sqlite3.OperationalError:
                    import time as _t
                    _t.sleep(0.005)
                    continue
                try:
                    row = self._db.execute(
                        "SELECT seq FROM kv WHERE key=?", (key,)).fetchone()
                    cur_seq = row[0] if row else 0
                    if expected_seq is not None and cur_seq != expected_seq:
                        raise TableVersionMismatched(
                            f"meta CAS failed on {key!r}: expected seq "
                            f"{expected_seq}, found {cur_seq}")
                    new_seq = cur_seq + 1
                    self._db.execute(
                        "INSERT INTO kv (key, seq, value) VALUES (?, ?, ?) "
                        "ON CONFLICT(key) DO UPDATE SET seq=?, value=?",
                        (key, new_seq, raw, new_seq, raw))
                    self._db.commit()
                    return new_seq
                except sqlite3.OperationalError:
                    # a locked commit is contention, not failure: the
                    # transaction rolled back cleanly, so re-run the CAS
                    self._db.rollback()
                    import time as _t
                    _t.sleep(0.005)
                    continue
                except BaseException:
                    self._db.rollback()
                    raise
            raise TableVersionMismatched(
                f"meta busy: could not lock {key!r} for CAS")

    def delete(self, key: str, expected_seq: Optional[int] = None) -> None:
        with self._lock:
            if self._mem is not None:
                _, cur_seq = self.get(key)
                if expected_seq is not None and cur_seq != expected_seq:
                    raise TableVersionMismatched(
                        f"meta CAS failed on {key!r}: expected seq "
                        f"{expected_seq}, found {cur_seq}")
                self._mem.pop(key, None)
                return
            for _ in range(64):
                try:
                    self._db.execute("BEGIN IMMEDIATE")
                except sqlite3.OperationalError:
                    import time as _t
                    _t.sleep(0.005)
                    continue
                try:
                    row = self._db.execute(
                        "SELECT seq FROM kv WHERE key=?", (key,)).fetchone()
                    cur_seq = row[0] if row else 0
                    if expected_seq is not None and cur_seq != expected_seq:
                        raise TableVersionMismatched(
                            f"meta CAS failed on {key!r}: expected seq "
                            f"{expected_seq}, found {cur_seq}")
                    self._db.execute("DELETE FROM kv WHERE key=?", (key,))
                    self._db.commit()
                    return
                except sqlite3.OperationalError:
                    self._db.rollback()
                    import time as _t
                    _t.sleep(0.005)
                    continue
                except BaseException:
                    self._db.rollback()
                    raise
            raise TableVersionMismatched(
                f"meta busy: could not lock {key!r} for delete")

    def next_id(self, counter: str) -> int:
        """Atomic id allocator (table ids, index ids). CAS-retried so
        concurrent allocators (other instances on the same sqlite file)
        never hand out the same id."""
        for _ in range(256):
            val, seq = self.get(f"__id/{counter}")
            nxt = (val or 0) + 1
            try:
                self.upsert(f"__id/{counter}", nxt, seq)
                return nxt
            except TableVersionMismatched:
                continue
        raise TableVersionMismatched(
            f"id allocator {counter!r}: CAS kept failing")

    # ------------------------------------------------- snapshot (raft mode)
    def dump(self) -> dict:
        """Serialize the full KV state (exact seqs preserved) for a raft
        snapshot."""
        with self._lock:
            if self._mem is not None:
                items = [[k, seq, raw] for k, (seq, raw)
                         in self._mem.items()]
            else:
                items = [[k, seq, raw] for k, raw, seq in self._db.execute(
                    "SELECT key, value, seq FROM kv").fetchall()]
            return {"kv": items}

    def restore(self, state: dict) -> None:
        """Replace the full KV state from a raft snapshot."""
        with self._lock:
            if self._mem is not None:
                self._mem = {k: (seq, raw) for k, seq, raw in state["kv"]}
                return
            self._db.execute("DELETE FROM kv")
            self._db.executemany(
                "INSERT INTO kv (key, seq, value) VALUES (?, ?, ?)",
                [(k, seq, raw) for k, seq, raw in state["kv"]])
            self._db.commit()

    def close(self):
        if self._db is not None:
            self._db.close()


class RemoteMetaStore:
    """MetaStore client over the standalone meta service process
    (reference: MetaStore::Remote — the grpc meta client,
    src/meta/store/src/lib.rs). Same interface as MetaStore; CAS
    conflicts surface as TableVersionMismatched exactly like the
    embedded store, so OCC retry loops work unchanged."""

    def __init__(self, endpoint: str, timeout: float = 10.0):
        # comma-separated endpoint list for raft deployments: the client
        # follows 421 leader redirects and rotates on connection failure
        # (reference: the meta grpc client's endpoint list + retry)
        self.endpoints = [e.rstrip("/") if e.startswith("http")
                          else "http://" + e.rstrip("/")
                          for e in endpoint.split(",")]
        self.endpoint = self.endpoints[0]
        self.timeout = timeout

    def _call(self, op: str, body: dict) -> dict:
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode()
        tried = 0
        candidates = [self.endpoint] + [e for e in self.endpoints
                                        if e != self.endpoint]
        last_err: Optional[Exception] = None
        while candidates and tried < 2 * len(self.endpoints) + 2:
            ep = candidates.pop(0)
            tried += 1
            req = urllib.request.Request(
                f"{ep}/v1/kv/{op}", data=data,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    self.endpoint = ep  # sticky leader
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                payload = {}
                try:
                    payload = json.loads(e.read())
                except Exception:
                    pass
                if e.code == 409 and payload.get("cas"):
                    raise TableVersionMismatched(payload.get("error", "CAS"))
                if e.code == 421 and payload.get("not_leader"):
                    leader = payload.get("leader")
                    if leader and leader.rstrip("/") != ep:
                        candidates.insert(0, leader.rstrip("/"))
                    else:  # election in progress: retry after a beat
                        import time as _t
                        _t.sleep(0.2)
                        candidates.append(ep)
                    last_err = RuntimeError(payload.get("error"))
                    continue
                raise RuntimeError(
                    f"meta service error {e.code}: {payload.get('error')}")
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last_err = e
                continue
        raise RuntimeError(
            f"meta service unreachable on {self.endpoints}: {last_err}")

    def get(self, key: str) -> Tuple[Optional[Any], int]:
        out = self._call("get", {"key": key})
        return out["value"], out["seq"]

    def list_prefix(self, prefix: str) -> List[Tuple[str, Any, int]]:
        out = self._call("list", {"prefix": prefix})
        return [(k, v, s) for k, v, s in out["items"]]

    def upsert(self, key: str, value: Any,
               expected_seq: Optional[int] = None) -> int:
        return self._call("upsert", {"key": key, "value": value,
                                     "expected_seq": expected_seq})["seq"]

    def delete(self, key: str, expected_seq: Optional[int] = None) -> None:
        self._call("delete", {"key": key, "expected_seq": expected_seq})

    def next_id(self, counter: str) -> int:
        return self._call("next_id", {"counter": counter})["id"]

    def status(self) -> dict:
        import urllib.request
        with urllib.request.urlopen(f"{self.endpoint}/v1/status",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def close(self):
        pass
