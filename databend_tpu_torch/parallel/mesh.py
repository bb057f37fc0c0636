"""Device-mesh construction for distributed query execution (port of
``databend_tpu/parallel/mesh.py``).

The reference scales out with stateless query nodes exchanging Arrow Flight
streams (reference: src/query/service/src/servers/flight/v1/exchange/
exchange_manager.rs:168, schedulers/fragments/fragmenter.rs:59). The
reference package replaces that data plane with a ``jax.sharding.Mesh`` and
XLA collectives; the port keeps the design over torch devices:

* a :class:`Mesh` is a ``[dp, shard]`` grid of ``torch.device``s, each
  position owned by one process (its rank). Table shards live on axis
  ``shard`` (the analog of Mod-sharded segments, reference
  read_partitions.rs:263-290) and query batches can additionally be split
  over axis ``dp``. A device may repeat: several logical shards on one card
  (or on the CPU, as the tests run), one shard a card, or any mix;
* a :class:`ShardedTensor` is one tensor per grid position this process
  owns, on that position's device, with its :class:`PartitionSpec` and its
  global shape; a position another process owns holds its :class:`Remote`
  marker. Positions that hold the same block on the same device share one
  tensor;
* a ``shard_map`` body of the reference becomes per-shard phases over the
  process's own positions (:func:`per_shard`) with a collective between
  them: :func:`all_gather`, :func:`psum` / :func:`pmax` / :func:`pmin`,
  :func:`all_to_all`. Each takes the per-shard list of one dp row (a tensor
  where this process owns the position, its ``Remote`` marker elsewhere)
  and returns each own position its result on that position's device,
  computed once per distinct device, in shard order whatever the owners.

A mesh built in one process (``make_mesh``) is owned entirely by it and its
collectives move tensors between its devices with ``.to(device)``. A mesh
that spans processes comes from ``parallel/multihost.join_cluster_mesh``:
query processes found in the meta registry join one ``torch.distributed``
process group, and a collective first reads the positions of the other
processes over it (``all_gather`` / ``all_to_all_single`` of byte buffers),
then computes exactly as in one process, so every rank gets bit-identical
values (a reduction runs after the gather, in shard order, never as an
``all_reduce`` in the backend's own order). The backend rule is
``multihost.choose_backend``: gloo on the CPU, NCCL when each rank has
cards of its own, gloo through host memory when ranks share a card.

Collective mapping (SURVEY §2.3):
  * Merge exchange (gather-to-one)  -> per-shard top-k + all_gather + k-select
  * Broadcast exchange              -> replicated sharding spec
  * Shuffle exchange                -> all_to_all
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import backend
from ..utils.metrics import METRICS

SHARD_AXIS = "shard"
DP_AXIS = "dp"

# jax runs without x64: 64-bit host arrays land as their 32-bit types
_DEVICE_DTYPE = {np.dtype(np.float64): np.float32,
                 np.dtype(np.int64): np.int32,
                 np.dtype(np.uint64): np.uint32}


class Remote:
    """A grid position another process owns, in a per-shard list: ``rank``
    is its owner. It stands where this process has no block."""

    __slots__ = ("rank",)

    def __init__(self, rank: int):
        self.rank = rank

    def __repr__(self):
        return f"Remote({self.rank})"


def is_remote(p) -> bool:
    return isinstance(p, Remote)


class Mesh:
    """``devices``: object array ``[dp, shard]`` of ``torch.device`` (None
    at a position another process owns); ``owners``: the rank that owns
    each position; ``rank``: this process's; ``backend``: the process
    group's backend, None in one process."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str],
                 owners: Optional[np.ndarray] = None, rank: int = 0,
                 backend: Optional[str] = None):
        self.devices = devices
        self.axis_names = axis_names
        self.owners = (np.full(devices.shape, rank, np.int64)
                       if owners is None
                       else np.asarray(owners, np.int64).reshape(
                           devices.shape))
        self.rank = rank
        self.backend = backend
        ranks = set(self.owners.ravel().tolist())
        for i, row in enumerate(self.owners):
            if set(row.tolist()) != ranks:
                # every process takes part in every row's collectives
                raise ValueError(f"dp row {i} lacks a position of ranks "
                                 f"{sorted(ranks - set(row.tolist()))}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_positions(self) -> List[Tuple[int, int]]:
        """The grid positions this process owns, row by row."""
        return [(int(i), int(j))
                for i, j in zip(*np.nonzero(self.owners == self.rank))]

    def regrid(self, dp: int = 1) -> "Mesh":
        """The same positions, owners and devices as ``dp`` rows."""
        n = self.devices.size
        if n % dp:
            raise ValueError(f"{n} positions not divisible by dp={dp}")
        return Mesh(self.devices.reshape(dp, n // dp), self.axis_names,
                    self.owners.reshape(dp, n // dp), self.rank,
                    self.backend)


class PartitionSpec(tuple):
    """Per leading dimension, the mesh axis it is split over (or None)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(dp, shard)`` mesh over ``n_devices`` (default: all of
    ``backend.devices()``), owned by this process. ``devices`` may repeat
    a device: each entry is one logical shard.

    ``dp`` splits the query batch; the remaining factor shards the corpus.
    """
    if devices is None:
        devices = backend.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, n_devices // dp), (DP_AXIS, SHARD_AXIS))


def corpus_sharding(mesh: Mesh) -> NamedSharding:
    """Rows of `[N, d]` corpus split over the ``shard`` axis (the analog of
    Mod-sharding table segments across query nodes)."""
    return NamedSharding(mesh, P(SHARD_AXIS, None))


def query_sharding(mesh: Mesh) -> NamedSharding:
    """Query batch `[B, d]` split over ``dp``, replicated over ``shard``."""
    return NamedSharding(mesh, P(DP_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh includes positions owned by other processes
    (several query nodes; reference: the multi-node cluster case)."""
    return bool((mesh.owners != mesh.rank).any())


class ShardedTensor:
    """A global array laid out on a mesh: ``parts[i, j]`` is grid position
    (i, j)'s block, on ``mesh.devices[i, j]``, where this process owns the
    position, and its :class:`Remote` marker where another does."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shape: tuple,
                 parts: np.ndarray):
        self.mesh = mesh
        self.spec = spec
        self.shape = tuple(shape)
        self.parts = parts

    @property
    def dtype(self) -> torch.dtype:
        return first_local(self.parts.flat).dtype

    def block(self, i: int, j: int) -> torch.Tensor:
        p = self.parts[i, j]
        if is_remote(p):
            raise ValueError(f"grid position ({i}, {j}) belongs to rank "
                             f"{p.rank}")
        return p

    def shards(self, i: int = 0) -> list:
        """The per-shard list of dp row ``i``, in shard order: this
        process's blocks, and the ``Remote`` marker of each position
        another process owns."""
        return list(self.parts[i])

    def numpy(self) -> np.ndarray:
        """The global array on the host, each block fetched once. On a
        mesh that spans processes a value split over ``shard`` is read
        with a collective: every process calls this together."""
        out = None
        dp = self.parts.shape[0]
        for i in range(dp if DP_AXIS in self.spec else 1):
            row = self.shards(i)
            blocks = (all_shards(row) if SHARD_AXIS in self.spec
                      else [first_local(row)])
            for j, b in enumerate(blocks):
                blk = backend.to_numpy(b)
                if out is None:
                    out = np.empty(self.shape, blk.dtype)
                out[_block_slices(self.spec, blk.shape, i, j)] = blk
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def _block_slices(spec, block_shape, i: int, j: int):
    out = []
    for d, size in enumerate(block_shape):
        axis = spec[d] if d < len(spec) else None
        idx = i if axis == DP_AXIS else j if axis == SHARD_AXIS else None
        out.append(slice(None) if idx is None
                   else slice(idx * size, (idx + 1) * size))
    return tuple(out)


def _block_shape(spec, shape, mesh: Mesh) -> tuple:
    sizes = mesh.shape
    out = list(shape)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if out[d] % sizes[axis]:
            raise ValueError(f"dimension {d} of size {out[d]} does not split "
                             f"over {sizes[axis]} {axis!r} positions")
        out[d] //= sizes[axis]
    return tuple(out)


def from_blocks(mesh: Mesh, spec: PartitionSpec, shape: tuple,
                block_of) -> ShardedTensor:
    """Assemble a sharded value: ``block_of(i, j)`` gives the block that
    grid position (i, j) holds, on that position's device; it is asked once
    per distinct block among this process's positions, and the block is
    copied to each other device of this process that holds it. Positions
    of other processes get their ``Remote`` marker."""
    dp, s = mesh.devices.shape
    made: Dict[tuple, torch.Tensor] = {}
    parts = np.empty((dp, s), dtype=object)
    for i in range(dp):
        for j in range(s):
            if mesh.owners[i, j] != mesh.rank:
                parts[i, j] = Remote(int(mesh.owners[i, j]))
                continue
            key = (i if DP_AXIS in spec else 0, j if SHARD_AXIS in spec else 0)
            dev = mesh.devices[i, j]
            if (key, dev) not in made:
                src = next((t for (k, _), t in made.items() if k == key),
                           None)
                made[(key, dev)] = (block_of(i, j) if src is None
                                    else src.to(dev, non_blocking=True))
            parts[i, j] = made[(key, dev)]
    return ShardedTensor(mesh, spec, shape, parts)


def _device_array(host_array) -> np.ndarray:
    host_array = np.asarray(host_array)
    want = _DEVICE_DTYPE.get(host_array.dtype)
    return host_array if want is None else host_array.astype(want)


def put_sharded(host_array: np.ndarray, mesh: Mesh,
                spec: PartitionSpec) -> ShardedTensor:
    """Place a host array onto the mesh under ``spec``: each block this
    process owns is uploaded once. On a mesh that spans processes every
    process holds the SAME full host array (SPMD at the SQL level: each
    query node scanned the same shared storage) and uploads only its own
    blocks. 64-bit arrays land as their 32-bit types, as the reference's do
    without x64."""
    host_array = _device_array(host_array)
    blk = _block_shape(spec, host_array.shape, mesh)

    def upload(i, j):
        return backend.to_device(
            host_array[_block_slices(spec, blk, i, j)],
            device=mesh.devices[i, j])

    return from_blocks(mesh, spec, host_array.shape, upload)


def device_put(host_array: np.ndarray, sharding: NamedSharding
               ) -> ShardedTensor:
    """``jax.device_put(x, NamedSharding(mesh, spec))``."""
    return put_sharded(host_array, sharding.mesh, sharding.spec)


def from_process_local(mesh: Mesh, spec: PartitionSpec,
                       local_data: np.ndarray) -> ShardedTensor:
    """``jax.make_array_from_process_local_data``: each process passes only
    its own rows, the blocks of the ``shard`` positions it owns
    concatenated in shard order along the split dimension (a value split
    over ``dp`` is not taken). A replicated ``spec`` takes the whole array.
    Every process must pass blocks of one shape."""
    local_data = _device_array(local_data)
    if DP_AXIS in spec:
        raise ValueError("a value split over 'dp' is not built from "
                         "process-local data")
    if SHARD_AXIS not in spec:
        return put_sharded(local_data, mesh, spec)
    d = list(spec).index(SHARD_AXIS)
    cols = sorted({j for _, j in mesh.local_positions()})
    if local_data.shape[d] % len(cols):
        raise ValueError(f"{local_data.shape[d]} local rows do not split "
                         f"over this process's {len(cols)} shards")
    size = local_data.shape[d] // len(cols)
    shape = list(local_data.shape)
    shape[d] = size * mesh.shape[SHARD_AXIS]

    def upload(i, j):
        m = cols.index(j)
        idx = [slice(None)] * local_data.ndim
        idx[d] = slice(m * size, (m + 1) * size)
        return backend.to_device(local_data[tuple(idx)],
                                 device=mesh.devices[i, j])

    return from_blocks(mesh, spec, tuple(shape), upload)


def shard_rows(x: np.ndarray, mesh: Mesh, pad_value: float = 1e18
               ) -> Tuple[ShardedTensor, int]:
    """Place a host `[N, d]` corpus onto the mesh row-sharded.

    Pads N up to a multiple of the shard-axis size with ``pad_value`` rows
    (distance-+inf-safe, never enter a top-k). Returns (sharded value,
    n_valid).
    """
    n = x.shape[0]
    s = mesh.shape[SHARD_AXIS]
    rem = (-n) % s
    if rem:
        pad = np.full((rem, x.shape[1]), pad_value, dtype=np.asarray(x).dtype)
        x = np.concatenate([np.asarray(x), pad], axis=0)
    return put_sharded(np.asarray(x), mesh, P(SHARD_AXIS, None)), n


# ------------------------------------------------------ per-shard phases


def per_shard(fn, *lists) -> list:
    """``fn(j, *entries)`` at each position of the per-shard lists that
    this process owns; a position another process owns keeps its
    ``Remote`` marker."""
    out = []
    for j, entries in enumerate(zip(*lists)):
        remote = next((e for e in entries if is_remote(e)), None)
        out.append(remote if remote is not None else fn(j, *entries))
    return out


def unzip(parts: Sequence, n: int) -> List[list]:
    """The n per-shard lists of a per-shard list of n-tuples."""
    return [[p if is_remote(p) else p[t] for p in parts] for t in range(n)]


def first_local(parts):
    """The first entry this process owns (a replicated result's value)."""
    for p in parts:
        if not is_remote(p):
            return p
    raise ValueError("this process owns no position of the list")


# ------------------------------------------------------------ collectives
#
# Each takes the per-shard values of one dp row (a tensor on its device
# where this process owns the position, its Remote marker elsewhere) and
# returns one result per position: shards that share a device share one
# result, other processes' positions keep their marker. Across processes
# the shards' blocks travel as bytes: every shard of a collective must have
# one shape and dtype (SPMD), and a header of both in each buffer makes a
# rank that disagrees fail instead of reading garbage. Each collective
# that crosses processes adds to the METRICS counters mesh_collectives,
# mesh_collective_seconds (wall time, staging included) and
# mesh_collective_bytes (sent by this process).


class _Group(NamedTuple):
    rank: int
    size: int
    device: torch.device    # where the buffers travel from: the CPU under
                            # gloo, this rank's current card under NCCL


def _group() -> _Group:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a per-shard list names another process's "
                           "position, but this process joined no process "
                           "group (parallel.multihost.join_cluster_mesh)")
    device = (torch.device("cpu") if dist.get_backend() == "gloo"
              else torch.device("cuda", torch.cuda.current_device()))
    return _Group(dist.get_rank(), dist.get_world_size(), device)


def _layout(parts, w: _Group):
    """(owner of each position, each rank's positions in shard order)."""
    owners = [p.rank if is_remote(p) else w.rank for p in parts]
    slots = {r: [j for j, o in enumerate(owners) if o == r]
             for r in range(w.size)}
    if not slots[w.rank]:
        raise ValueError("this process owns no position of the list")
    return owners, slots


_HEADER = 16   # bytes: int64 byte count, int64 crc32 of shape and dtype


def _header(t: torch.Tensor, device) -> torch.Tensor:
    nb = t.numel() * t.element_size()
    sig = zlib.crc32(repr((tuple(t.shape), str(t.dtype))).encode())
    return torch.tensor([nb, sig], dtype=torch.int64).view(
        torch.uint8).to(device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf[_HEADER:].view(like.dtype).reshape(like.shape)


def _check_headers(heads: torch.Tensor, want: torch.Tensor, present):
    """Each received buffer that holds a block (``present``, a bool mask
    over the leading axes) carries the header of this rank's own."""
    bad = present & (heads != want).any(-1)
    if bool(bad.any()):
        raise RuntimeError("a collective's shards differ in shape or dtype "
                           "between processes")


def _timed(fn):
    t0 = time.perf_counter()
    out, nbytes = fn()
    METRICS.inc("mesh_collectives")
    METRICS.inc("mesh_collective_seconds", time.perf_counter() - t0)
    METRICS.inc("mesh_collective_bytes", nbytes)
    return out


def all_shards(parts) -> list:
    """Every position's value in shard order: this process's own, and on
    a mesh that spans processes the others' read from their owners (one
    ``all_gather`` of byte buffers), on this process's first position's
    device."""
    if not any(is_remote(p) for p in parts):
        return list(parts)
    import torch.distributed as dist
    w = _group()
    owners, slots = _layout(parts, w)
    mine = [parts[j] for j in slots[w.rank]]
    home = mine[0].device
    width = max(len(v) for v in slots.values())
    head = _header(mine[0], home)

    def comm():
        nb = mine[0].numel() * mine[0].element_size()
        send = torch.zeros((width, _HEADER + nb), dtype=torch.uint8,
                           device=home)
        for m, p in enumerate(mine):
            if p.shape != mine[0].shape or p.dtype != mine[0].dtype:
                raise ValueError("a collective's shards differ in shape or "
                                 "dtype")
            send[m, :_HEADER] = head
            send[m, _HEADER:] = _as_bytes(p.to(home))
        send = send.to(w.device)
        recv = [torch.empty_like(send) for _ in range(w.size)]
        dist.all_gather(recv, send)
        got = torch.stack(recv).to(home)            # [size, width, bytes]
        present = torch.tensor(
            [[m < len(slots[r]) for m in range(width)]
             for r in range(w.size)], device=home)
        _check_headers(got[:, :, :_HEADER], head, present)
        return got, send.numel()

    got = _timed(comm)
    return [parts[j] if o == w.rank
            else _from_bytes(got[o, slots[o].index(j)], mine[0])
            for j, o in enumerate(owners)]


def _per_device(parts: Sequence, fn) -> list:
    full = all_shards(parts)
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        if is_remote(p):
            out.append(p)
            continue
        if p.device not in done:
            done[p.device] = fn([q.to(p.device, non_blocking=True)
                                 for q in full])
        out.append(done[p.device])
    return out


def all_gather(parts: Sequence, tiled: bool = False) -> list:
    """Every shard gets every shard's value, stacked on a new leading axis
    (``[S, ...]``) or, ``tiled``, concatenated along axis 0."""
    return _per_device(parts, torch.cat if tiled else torch.stack)


def gather(parts: Sequence, tiled: bool = False) -> torch.Tensor:
    """``all_gather``'s result at this process's first position."""
    home = first_local(parts).device
    full = [q.to(home, non_blocking=True) for q in all_shards(parts)]
    return torch.cat(full) if tiled else torch.stack(full)


def _reduce(parts, op):
    def fn(moved):
        acc = moved[0]
        for t in moved[1:]:
            acc = op(acc, t)
        return acc
    return _per_device(parts, fn)


def psum(parts: Sequence) -> list:
    """Sum over the shards, in shard order (after the gather, so that every
    process gets the same bits)."""
    return _reduce(parts, torch.add)


def pmax(parts: Sequence) -> list:
    return _reduce(parts, torch.maximum)


def pmin(parts: Sequence) -> list:
    return _reduce(parts, torch.minimum)


def _exchange_chunks(parts, split_axis: int) -> Dict[int, list]:
    """The all_to_all across processes: for each position this process
    owns, the chunk every position (in shard order) sends it, read with one
    ``all_to_all_single`` of byte buffers ``[rank, source, destination]``,
    on this process's first position's device."""
    import torch.distributed as dist
    w = _group()
    s = len(parts)
    owners, slots = _layout(parts, w)
    mine = [parts[j] for j in slots[w.rank]]
    home = mine[0].device
    if mine[0].shape[split_axis] % s:
        raise ValueError(f"axis {split_axis} of size "
                         f"{mine[0].shape[split_axis]} does not split over "
                         f"{s} shards")
    width = max(len(v) for v in slots.values())
    chunks = [torch.stack(torch.chunk(p.to(home), s, dim=split_axis))
              for p in mine]                        # each [s, *chunk]
    like = chunks[0][0]
    head = _header(like, home)

    def comm():
        nb = like.numel() * like.element_size()
        send = torch.zeros((w.size, width, width, _HEADER + nb),
                           dtype=torch.uint8, device=home)
        for m, c in enumerate(chunks):
            if c.shape != chunks[0].shape or c.dtype != like.dtype:
                raise ValueError("a collective's shards differ in shape or "
                                 "dtype")
            flat = c.reshape(s, -1).view(torch.uint8)   # [s, nb]
            for r in range(w.size):
                dst = slots[r]
                send[r, m, :len(dst), :_HEADER] = head
                send[r, m, :len(dst), _HEADER:] = flat[dst]
        send = send.to(w.device)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        recv = recv.to(home)                # [src rank, src m, my m, bytes]
        present = torch.tensor(
            [[[a < len(slots[r]) and b < len(slots[w.rank])
               for b in range(width)] for a in range(width)]
             for r in range(w.size)], device=home)
        _check_headers(recv[..., :_HEADER], head, present)
        return recv, send.numel()

    recv = _timed(comm)
    return {i: [_from_bytes(recv[owners[j], slots[owners[j]].index(j), m],
                            like) for j in range(s)]
            for m, i in enumerate(slots[w.rank])}


def all_to_all(parts: Sequence, split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = True) -> list:
    """The shuffle: each shard's value splits into S chunks along
    ``split_axis``; chunk i of every shard lands on shard i, concatenated
    along ``concat_axis`` in source-shard order (``tiled``; otherwise
    stacked on a new axis ``concat_axis``)."""
    s = len(parts)
    if any(is_remote(p) for p in parts):
        got = _exchange_chunks(parts, split_axis)
    else:
        chunks = [torch.chunk(p, s, dim=split_axis) for p in parts]
        got = {i: [chunks[src][i] for src in range(s)] for i in range(s)}
    out = []
    for i, p in enumerate(parts):
        if is_remote(p):
            out.append(p)
            continue
        recv = [c.to(p.device, non_blocking=True) for c in got[i]]
        out.append(torch.cat(recv, dim=concat_axis) if tiled
                   else torch.stack(recv, dim=concat_axis))
    return out


_DEFAULT_MESH = None


def set_default_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Install ``mesh`` as the process-wide mesh of the distributed
    operators (None uninstalls); returns the one it replaces. A mesh of
    logical shards on one device (``make_mesh(4, devices=[dev] * 4)``)
    runs every exchange on a single card or on the CPU."""
    global _DEFAULT_MESH
    old, _DEFAULT_MESH = _DEFAULT_MESH, mesh
    return old


def get_default_mesh() -> Optional[Mesh]:
    """Process-wide mesh: the installed one, else a mesh over all of
    ``backend.devices()`` (None when single-device — distributed paths
    fall back to the host operators)."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        devs = backend.devices()
        if len(devs) < 2:
            return None
        _DEFAULT_MESH = make_mesh(len(devs))
    return _DEFAULT_MESH
