"""Multi-process cluster join: meta-service topology -> torch.distributed
(port of ``databend_tpu/parallel/multihost.py``).

The reference builds its per-query node list from the meta service
(reference: src/query/service/src/clusters/cluster.rs:83,620 —
ClusterDiscovery registers/heartbeats nodes and every query plans against
the discovered list; exchange_manager.rs:168 then opens Flight channels).
Here query processes register in the same meta KV, and the *registered
topology* names the rendezvous address and each process's rank: after
``join_cluster_mesh`` the default mesh spans every process's positions and
the exchanges (psum merge, ordered top-n, shuffle) read the other
processes' shards over one ``torch.distributed`` process group
(``mesh.py``'s collectives).

SPMD at the SQL level: each process executes the same statement; scans
read the same shared storage, so host-side states agree, every process
uploads only the blocks of its own positions, and every process reads the
same result.

The backend follows one rule, taken from the registry before the process
group exists (so every process takes the same): gloo when the nodes run on
the CPU; NCCL when they run on cards and no card is registered by two
nodes (each rank has cards of its own); gloo through host memory when two
nodes share a card (NCCL refuses two ranks on one card). Nothing switches
backend on a failure: a failed init raises.
"""

from __future__ import annotations

import datetime
import time
from typing import Optional

import numpy as np
import torch

from .. import backend
from . import mesh as _m


def choose_backend(nodes) -> str:
    """The process group's backend for the registered ``nodes``, from the
    device kind and cards each registered (``backend.identity()``)."""
    kinds = {n.extra.get("device") for n in nodes}
    if None in kinds or len(kinds) != 1:
        raise ValueError(f"the nodes register no single device kind: "
                         f"{sorted(map(str, kinds))}")
    if kinds == {"cpu"}:
        return "gloo"
    cards = [n.extra.get("cards", "").split(",") for n in nodes]
    if not all(c and all(c) for c in cards):
        raise ValueError("a node on cards registered no card ids")
    flat = [c for node in cards for c in node]
    return "nccl" if len(set(flat)) == len(flat) else "gloo"


def join_cluster_mesh(meta, my_node_id: str, n_expected: int,
                      cluster_id: str = "default",
                      timeout: float = 60.0,
                      local_device_count: Optional[int] = None):
    """Wait for ``n_expected`` registered query nodes, join the process
    group they define, and install the global mesh.

    Rendezvous and ranks come from the meta registry: nodes sort by
    node_id (every process reads the same list, so all agree); the first
    node's ``address`` (``host:port``) is the rendezvous endpoint and a
    process's rank is its place in the list. ``local_device_count`` is the
    number of mesh positions this process contributes (default: one a
    device it sees), over its devices in turn: its own cards, or logical
    shards of one card or of the CPU. The mesh is ``[1, positions]`` in
    rank order, then local order. ``timeout`` bounds the wait for the
    registry and is the process group's timeout (rendezvous and each
    collective). Returns (mesh, rank).
    """
    import torch.distributed as dist
    from ..meta.cluster import ClusterDiscovery
    disc = ClusterDiscovery(meta, cluster_id=cluster_id)
    deadline = time.time() + timeout
    nodes = []
    while time.time() < deadline:
        nodes = disc.list_nodes()
        if len(nodes) >= n_expected:
            break
        time.sleep(0.05)
    if len(nodes) < n_expected:
        raise TimeoutError(
            f"only {len(nodes)}/{n_expected} query nodes registered")
    nodes = nodes[:n_expected]
    ids = [n.node_id for n in nodes]
    if my_node_id not in ids:
        raise ValueError(f"local node {my_node_id!r} not in registry")
    rank = ids.index(my_node_id)
    name = choose_backend(nodes)
    devs = backend.devices()
    if nodes[rank].extra.get("device") != devs[0].type:
        raise ValueError(f"node {my_node_id!r} registered device "
                         f"{nodes[rank].extra.get('device')!r}, but this "
                         f"process runs on {devs[0].type!r}")
    n_local = len(devs) if local_device_count is None \
        else int(local_device_count)
    if n_local < 1:
        raise ValueError(f"local_device_count={n_local}")
    mine = [devs[i % len(devs)] for i in range(n_local)]
    if name == "nccl":
        torch.cuda.set_device(mine[0])
        comm = mine[0]
    else:
        comm = torch.device("cpu")
    dist.init_process_group(
        name, init_method=f"tcp://{nodes[0].address}",
        world_size=len(nodes), rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    counts = [torch.zeros(1, dtype=torch.int64, device=comm)
              for _ in range(len(nodes))]
    dist.all_gather(counts, torch.tensor([n_local], device=comm))
    owners = np.repeat(np.arange(len(nodes)),
                       [int(c.item()) for c in counts])
    devices = np.empty(owners.size, dtype=object)
    devices[owners == rank] = mine
    mesh = _m.Mesh(devices.reshape(1, -1), (_m.DP_AXIS, _m.SHARD_AXIS),
                   owners.reshape(1, -1), rank=rank, backend=name)
    set_default_mesh(mesh)
    return mesh, rank


def leave_cluster_mesh() -> None:
    """Uninstall the default mesh and leave the process group."""
    import torch.distributed as dist
    set_default_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def set_default_mesh(mesh) -> None:
    """Install ``mesh`` as the process-wide default the distributed
    executor paths pick up (parallel/mesh.get_default_mesh)."""
    _m.set_default_mesh(mesh)
