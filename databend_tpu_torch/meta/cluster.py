"""Cluster membership + distributed coordination over the meta KV.

Reference analogs: ``ClusterDiscovery`` (src/query/service/src/clusters/
cluster.rs:83,620 — query nodes register in the meta service and heartbeat;
the per-query node list is read from it, with tolerance for heartbeat loss)
and the meta plugins' distributed semaphore/lock (src/meta/plugins/).

TPU-native framing: the data plane inside one host is the device mesh (XLA
collectives over ICI — no RPC), so "cluster membership" here serves the
CONTROL plane: which server processes exist, who owns a table lock, and
admission coordination across processes sharing one sqlite-backed meta
store (WAL mode: safe across processes on one host — the stand-in for the
reference's raft group).

Leases are expiry timestamps in the value; expiry is evaluated by readers,
so no background reaper is required (matches the reference's tolerance
windows, cluster.rs:355-384).
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..errors import TableVersionMismatched

DEFAULT_TTL_SECS = 60.0


@dataclass
class NodeInfo:
    """One query-server process (reference NodeInfo, cluster.rs)."""

    node_id: str
    address: str = ""          # protocol endpoint, e.g. http://host:8124
    version: str = ""
    cpu_count: int = 0
    device_count: int = 0
    cluster_id: str = "default"
    extra: Dict[str, str] = field(default_factory=dict)

    def to_dict(self):
        return {"node_id": self.node_id, "address": self.address,
                "version": self.version, "cpu_count": self.cpu_count,
                "device_count": self.device_count,
                "cluster_id": self.cluster_id, "extra": self.extra}

    @staticmethod
    def from_dict(d):
        return NodeInfo(d["node_id"], d.get("address", ""),
                        d.get("version", ""), d.get("cpu_count", 0),
                        d.get("device_count", 0),
                        d.get("cluster_id", "default"), d.get("extra", {}))


class ClusterDiscovery:
    """Register/heartbeat/list server processes in the meta KV."""

    def __init__(self, meta, cluster_id: str = "default",
                 ttl_secs: float = DEFAULT_TTL_SECS):
        self.meta = meta
        self.cluster_id = cluster_id
        self.ttl = ttl_secs

    def _key(self, node_id: str) -> str:
        return f"cluster/{self.cluster_id}/nodes/{node_id}"

    @staticmethod
    def local_node(address: str = "", cluster_id: str = "default") -> NodeInfo:
        from .. import backend
        from ..version import __version__
        return NodeInfo(
            node_id=f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}",
            address=address, version=__version__,
            cpu_count=os.cpu_count() or 1,
            device_count=len(backend.devices()),
            cluster_id=cluster_id, extra=backend.identity())

    def register(self, node: NodeInfo) -> None:
        """Idempotent upsert with a fresh lease (cluster.rs:620
        register_to_metastore)."""
        self.meta.upsert(self._key(node.node_id),
                         {"node": node.to_dict(),
                          "expires_at": time.time() + self.ttl})

    def heartbeat(self, node_id: str) -> bool:
        """Extend the lease; False when the registration vanished (the
        node must re-register, like the reference's heartbeat recovery)."""
        key = self._key(node_id)
        v, seq = self.meta.get(key)
        if v is None:
            return False
        v["expires_at"] = time.time() + self.ttl
        try:
            self.meta.upsert(key, v, seq)
        except TableVersionMismatched:
            return self.heartbeat(node_id)
        return True

    def unregister(self, node_id: str) -> None:
        self.meta.delete(self._key(node_id))

    def list_nodes(self, include_expired: bool = False) -> List[NodeInfo]:
        now = time.time()
        out = []
        for _, v, _ in self.meta.list_prefix(f"cluster/{self.cluster_id}/nodes/"):
            if include_expired or v.get("expires_at", 0) > now:
                out.append(NodeInfo.from_dict(v["node"]))
        return sorted(out, key=lambda n: n.node_id)


class DistributedLock:
    """Lease-based exclusive lock over the meta KV (reference: the lock
    API in src/query/catalog lock + meta plugins semaphore). CAS on the
    key's seq makes acquisition race-free across processes; expired leases
    are claimable by anyone."""

    def __init__(self, meta, name: str, owner: Optional[str] = None,
                 ttl_secs: float = 30.0):
        self.meta = meta
        self.key = f"locks/{name}"
        self.owner = owner or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.ttl = ttl_secs

    def try_acquire(self) -> bool:
        v, seq = self.meta.get(self.key)
        now = time.time()
        if v is not None and v.get("expires_at", 0) > now \
                and v.get("owner") != self.owner:
            return False
        try:
            self.meta.upsert(self.key,
                             {"owner": self.owner,
                              "expires_at": now + self.ttl}, seq)
            return True
        except TableVersionMismatched:
            return False

    def acquire(self, timeout_secs: float = 30.0,
                poll_secs: float = 0.05) -> bool:
        deadline = time.monotonic() + timeout_secs
        while time.monotonic() < deadline:
            if self.try_acquire():
                return True
            time.sleep(poll_secs)
        return False

    def release(self) -> None:
        v, seq = self.meta.get(self.key)
        if v is not None and v.get("owner") == self.owner:
            try:
                self.meta.delete(self.key, seq)
            except TableVersionMismatched:
                pass

    def __enter__(self):
        from ..errors import QueueTimeout
        if not self.acquire():
            raise QueueTimeout(f"could not acquire lock {self.key}")
        return self

    def __exit__(self, *exc):
        self.release()


class DistributedSemaphore:
    """N-permit semaphore over the meta KV (reference meta plugins
    semaphore): permits are lease keys; expired permits free themselves."""

    def __init__(self, meta, name: str, permits: int,
                 ttl_secs: float = 30.0):
        self.meta = meta
        self.name = name
        self.permits = permits
        self.ttl = ttl_secs
        self.holder = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"

    def _prefix(self) -> str:
        return f"semaphores/{self.name}/"

    def try_acquire(self) -> Optional[str]:
        now = time.time()
        held = [(k, v, seq) for k, v, seq in
                self.meta.list_prefix(self._prefix())
                if v.get("expires_at", 0) > now]
        if len(held) >= self.permits:
            return None
        token = f"{self._prefix()}{self.holder}-{uuid.uuid4().hex[:6]}"
        try:
            self.meta.upsert(token, {"holder": self.holder,
                                     "expires_at": now + self.ttl}, 0)
        except TableVersionMismatched:
            return None
        # re-check: last writers past the limit back off (CAS on distinct
        # keys can admit >N transiently; the settle pass keeps the first N)
        now = time.time()
        held = sorted(k for k, v, _ in self.meta.list_prefix(self._prefix())
                      if v.get("expires_at", 0) > now)
        if token not in held[:self.permits]:
            self.meta.delete(token)
            return None
        return token

    def release(self, token: str) -> None:
        self.meta.delete(token)
