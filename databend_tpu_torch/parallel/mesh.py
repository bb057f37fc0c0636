"""Device-mesh construction for distributed query execution (port of
``databend_tpu/parallel/mesh.py``).

The reference scales out with stateless query nodes exchanging Arrow Flight
streams (reference: src/query/service/src/servers/flight/v1/exchange/
exchange_manager.rs:168, schedulers/fragments/fragmenter.rs:59). The
reference package replaces that data plane with a ``jax.sharding.Mesh`` and
XLA collectives; the port keeps the design in one process over torch
devices:

* a :class:`Mesh` is a ``[dp, shard]`` grid of ``torch.device``s. Table
  shards live on axis ``shard`` (the analog of Mod-sharded segments,
  reference read_partitions.rs:263-290) and query batches can additionally
  be split over axis ``dp``. A device may repeat: several logical shards on
  one card (or on the CPU, as the tests run), one shard a card, or any mix;
* a :class:`ShardedTensor` is one tensor per grid position on that
  position's device, with its :class:`PartitionSpec` and its global shape.
  Positions that hold the same block on the same device share one tensor;
* a ``shard_map`` body of the reference becomes per-shard phases over the
  shards' tensors with a collective between them: :func:`all_gather`,
  :func:`psum` / :func:`pmax` / :func:`pmin`, :func:`all_to_all`. Each
  takes the list of per-shard values and returns each shard its result on
  that shard's device, computed once per distinct device. Values move
  between distinct devices with ``.to(device, non_blocking=True)`` and stay
  in place on one device.

Collective mapping (SURVEY §2.3):
  * Merge exchange (gather-to-one)  -> per-shard top-k + all_gather + k-select
  * Broadcast exchange              -> replicated sharding spec
  * Shuffle exchange                -> all_to_all

One process only: ``mesh_spans_processes`` is False. Meshes that join
several processes are ``parallel/multihost.py``'s, which the port has not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import backend

SHARD_AXIS = "shard"
DP_AXIS = "dp"

# jax runs without x64: 64-bit host arrays land as their 32-bit types
_DEVICE_DTYPE = {np.dtype(np.float64): np.float32,
                 np.dtype(np.int64): np.int32,
                 np.dtype(np.uint64): np.uint32}


class Mesh:
    """``devices``: object array ``[dp, shard]`` of ``torch.device``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


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
    ``backend.devices()``). ``devices`` may repeat a device: each entry is
    one logical shard.

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
    """True when the mesh includes devices owned by other processes; the
    port's meshes live in one process."""
    return False


class ShardedTensor:
    """A global array laid out on a mesh: ``parts[i, j]`` is grid position
    (i, j)'s block, on ``mesh.devices[i, j]``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shape: tuple,
                 parts: np.ndarray):
        self.mesh = mesh
        self.spec = spec
        self.shape = tuple(shape)
        self.parts = parts

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0, 0].dtype

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.parts[i, j]

    def shards(self, i: int = 0) -> List[torch.Tensor]:
        """The blocks of dp row ``i``, in shard order."""
        return list(self.parts[i])

    def numpy(self) -> np.ndarray:
        """The global array on the host, each block fetched once."""
        out = None
        dp, s = self.parts.shape
        for i in range(dp if DP_AXIS in self.spec else 1):
            for j in range(s if SHARD_AXIS in self.spec else 1):
                blk = backend.to_numpy(self.parts[i, j])
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
    per distinct block, and the block is copied to each other device that
    holds it."""
    dp, s = mesh.devices.shape
    made: Dict[tuple, torch.Tensor] = {}
    parts = np.empty((dp, s), dtype=object)
    for i in range(dp):
        for j in range(s):
            key = (i if DP_AXIS in spec else 0, j if SHARD_AXIS in spec else 0)
            dev = mesh.devices[i, j]
            if (key, dev) not in made:
                src = next((t for (k, _), t in made.items() if k == key),
                           None)
                made[(key, dev)] = (block_of(i, j) if src is None
                                    else src.to(dev, non_blocking=True))
            parts[i, j] = made[(key, dev)]
    return ShardedTensor(mesh, spec, shape, parts)


def put_sharded(host_array: np.ndarray, mesh: Mesh,
                spec: PartitionSpec) -> ShardedTensor:
    """Place a host array onto the mesh under ``spec``: each block is
    uploaded once. 64-bit arrays land as their 32-bit types, as the
    reference's do without x64."""
    host_array = np.asarray(host_array)
    want = _DEVICE_DTYPE.get(host_array.dtype)
    if want is not None:
        host_array = host_array.astype(want)
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


# ------------------------------------------------------------ collectives
#
# Each takes the per-shard values (one tensor per shard, on its device) and
# returns one result per shard, on that shard's device; shards that share a
# device share one result.


def _per_device(parts: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        if p.device not in done:
            done[p.device] = fn([q.to(p.device, non_blocking=True)
                                 for q in parts])
        out.append(done[p.device])
    return out


def all_gather(parts: Sequence[torch.Tensor], tiled: bool = False
               ) -> List[torch.Tensor]:
    """Every shard gets every shard's value, stacked on a new leading axis
    (``[S, ...]``) or, ``tiled``, concatenated along axis 0."""
    return _per_device(parts, torch.cat if tiled else torch.stack)


def _reduce(parts, op):
    def fn(moved):
        acc = moved[0]
        for t in moved[1:]:
            acc = op(acc, t)
        return acc
    return _per_device(parts, fn)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over the shards, in shard order."""
    return _reduce(parts, torch.add)


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(parts, torch.maximum)


def pmin(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return _reduce(parts, torch.minimum)


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True
               ) -> List[torch.Tensor]:
    """The shuffle: each shard's value splits into S chunks along
    ``split_axis``; chunk i of every shard lands on shard i, concatenated
    along ``concat_axis`` in source-shard order (``tiled``; otherwise
    stacked on a new axis ``concat_axis``)."""
    s = len(parts)
    chunks = [torch.chunk(p, s, dim=split_axis) for p in parts]
    out = []
    for i, p in enumerate(parts):
        recv = [chunks[src][i].to(p.device, non_blocking=True)
                for src in range(s)]
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
