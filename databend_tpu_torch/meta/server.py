"""Standalone meta service process, optionally raft-replicated.

Reference: query nodes talk gRPC to a raft-replicated `databend-meta`
service (Cargo.toml:170, src/meta/store/src/local.rs — MetaStore is
either an embedded local store or a grpc client). The TPU-native
deployment mirrors that process boundary with a small HTTP KV service
wrapping the same OCC `MetaStore`: query processes dial it through
`RemoteMetaStore` when `meta_endpoint` is configured, so the cluster
registry, leases, locks and the catalog all live in ONE shared meta
deployment instead of per-process embedded KVs.

Single node:
  python -m databend_tpu.meta.server --port 9191 [--path meta.db]

Raft cluster (reference: the 3-replica databend-meta deployment):
  python -m databend_tpu.meta.server --port 9191 --raft-id n1 \
      --raft-peers n1=127.0.0.1:9191,n2=127.0.0.1:9192,n3=127.0.0.1:9193
  (one process per peer; KV mutations replicate through the raft log,
  followers answer 421 with the leader endpoint and clients follow)

API (JSON over POST, mirroring the MetaStore methods 1:1):
  /v1/kv/get      {key}                        -> {value, seq}
  /v1/kv/list     {prefix}                     -> {items: [[k, v, seq]..]}
  /v1/kv/upsert   {key, value, expected_seq?}  -> {seq} | 409 CAS error
  /v1/kv/delete   {key, expected_seq?}         -> {} | 409
  /v1/kv/next_id  {counter}                    -> {id}
  /v1/raft/request_vote | /v1/raft/append_entries   (peer RPCs)
  GET /v1/status                               -> {role, keys, raft...}
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..errors import TableVersionMismatched
from .kv import MetaStore

_MUTATIONS = {"upsert", "delete", "next_id"}


class MetaService:
    def __init__(self, path: Optional[str] = None,
                 raft_id: Optional[str] = None,
                 raft_peers: Optional[Dict[str, str]] = None,
                 election_timeout=(0.4, 0.8), heartbeat: float = 0.12,
                 compact_threshold: int = 1024,
                 raft_learner: bool = False):
        self.started = time.time()
        self.raft = None
        self.peer_endpoints: Dict[str, str] = {}
        if raft_id is not None:
            # raft mode: the durable truth is the raft log + snapshot (one
            # sqlite file); the KV state machine itself is in-memory and is
            # rebuilt on boot from snapshot + log replay. (A durable store
            # NEXT TO a durable log would double-apply entries on restart:
            # last_applied isn't — and can't atomically be — persisted in a
            # separate file.)
            self.store = MetaStore(None)
            from .raft import RaftNode
            self.peer_endpoints = {
                k: (v if v.startswith("http") else f"http://{v}")
                for k, v in (raft_peers or {}).items()}
            log_path = path + ".raftlog" if path else None
            self.raft = RaftNode(
                raft_id, self.peer_endpoints, self._apply,
                log_path=log_path, election_timeout=election_timeout,
                heartbeat=heartbeat, snapshot_fn=self.store.dump,
                restore_fn=self.store.restore,
                compact_threshold=compact_threshold,
                learner=raft_learner)
        else:
            self.store = MetaStore(path)

    def _apply(self, op: dict):
        """Deterministic state-machine apply for replicated mutations."""
        return self._run_local(op["op"], op["body"])

    def _run_local(self, op: str, body: dict):
        if op == "get":
            value, seq = self.store.get(body["key"])
            return {"value": value, "seq": seq}
        if op == "list":
            items = self.store.list_prefix(body["prefix"])
            return {"items": [[k, v, s] for k, v, s in items]}
        if op == "upsert":
            seq = self.store.upsert(body["key"], body["value"],
                                    body.get("expected_seq"))
            return {"seq": seq}
        if op == "delete":
            self.store.delete(body["key"], body.get("expected_seq"))
            return {}
        if op == "next_id":
            return {"id": self.store.next_id(body["counter"])}
        raise ValueError(f"unknown op {op!r}")

    def handle(self, op: str, body: dict):
        if self.raft is not None:
            if op in _MUTATIONS:
                return self.raft.propose({"op": op, "body": body})
            # linearizable reads: read-index barrier (leader-lease fast
            # path) — a deposed leader raises NotLeader instead of
            # serving stale data (see raft.py read_index)
            self.raft.read_index()
        return self._run_local(op, body)

    def leader_endpoint(self) -> Optional[str]:
        if self.raft is None or self.raft.leader_id is None:
            return None
        lid = self.raft.leader_id
        return self.peer_endpoints.get(lid) or self.raft.peers.get(lid)

    def status(self):
        n = len(self.store.list_prefix(""))
        out = {"role": "leader", "keys": n,
               "uptime_s": time.time() - self.started}
        if self.raft is not None:
            rs = self.raft.status()
            out["role"] = rs["role"]
            out["raft"] = rs
        return out

    def close(self):
        if self.raft is not None:
            self.raft.stop()
        self.store.close()


def make_handler(svc: MetaService):
    from .raft import NotLeader

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/v1/status":
                return self._reply(200, svc.status())
            return self._reply(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) or b"{}"
            if self.path.startswith("/v1/raft/"):
                if svc.raft is None:
                    return self._reply(400, {"error": "raft not enabled"})
                rpc = self.path[len("/v1/raft/"):]
                body = json.loads(raw)
                if rpc == "request_vote":
                    return self._reply(200,
                                       svc.raft.handle_request_vote(body))
                if rpc == "append_entries":
                    return self._reply(200,
                                       svc.raft.handle_append_entries(body))
                if rpc == "install_snapshot":
                    return self._reply(
                        200, svc.raft.handle_install_snapshot(body))
                if rpc == "add_voter":
                    try:
                        svc.raft.add_voter(body["id"], body["endpoint"])
                        return self._reply(200, {"ok": True})
                    except NotLeader as e:
                        return self._reply(421, {
                            "error": str(e), "not_leader": True,
                            "leader": svc.leader_endpoint()})
                if rpc == "remove_voter":
                    try:
                        svc.raft.remove_voter(body["id"])
                        return self._reply(200, {"ok": True})
                    except NotLeader as e:
                        return self._reply(421, {
                            "error": str(e), "not_leader": True,
                            "leader": svc.leader_endpoint()})
                return self._reply(404, {"error": "not found"})
            if not self.path.startswith("/v1/kv/"):
                return self._reply(404, {"error": "not found"})
            op = self.path[len("/v1/kv/"):]
            try:
                body = json.loads(raw)
                out = svc.handle(op, body)
                return self._reply(200, out)
            except NotLeader as e:
                return self._reply(421, {
                    "error": str(e), "not_leader": True,
                    "leader": svc.leader_endpoint()})
            except TableVersionMismatched as e:
                return self._reply(409, {"error": str(e), "cas": True})
            except Exception as e:
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(port: int, path: Optional[str] = None, host: str = "127.0.0.1",
          in_thread: bool = False, raft_id: Optional[str] = None,
          raft_peers: Optional[Dict[str, str]] = None,
          election_timeout=(0.4, 0.8), heartbeat: float = 0.12,
          compact_threshold: int = 1024, raft_learner: bool = False):
    svc = MetaService(path, raft_id=raft_id, raft_peers=raft_peers,
                      election_timeout=election_timeout,
                      heartbeat=heartbeat,
                      compact_threshold=compact_threshold,
                      raft_learner=raft_learner)
    httpd = ThreadingHTTPServer((host, port), make_handler(svc))
    httpd.meta_service = svc
    if in_thread:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()


def main(argv=None):  # pragma: no cover
    """Layered config (defaults < toml < env < CLI), mirroring the
    reference databend-meta binary (src/meta/cli-config)."""
    import sys

    from .cli_config import MetaServerConfig
    cfg = MetaServerConfig.load(sys.argv[1:] if argv is None else argv)
    peers = cfg.raft_peers or None
    mode = f"raft {cfg.raft_id}" if cfg.raft_id else "standalone"
    print(f"meta service on {cfg.host}:{cfg.port} ({mode}, "
          f"{'sqlite ' + cfg.path if cfg.path else 'in-memory'})",
          flush=True)
    serve(cfg.port, cfg.path, cfg.host, raft_id=cfg.raft_id,
          raft_peers=peers,
          election_timeout=(cfg.election_timeout_min,
                            cfg.election_timeout_max),
          heartbeat=cfg.heartbeat_interval)


if __name__ == "__main__":  # pragma: no cover
    main()
