"""Grouped integer sums of the device scan-aggregate route.

The reference's grouping engines (``databend_tpu/pipeline/device_scan_agg.py``,
``_build_program``: the "mask" engine's G x K masked sums and the "matmul"
engine's one-hot int8 product) are XLA programs; both compute one function::

    acc[k, g] = sum of rows[k][i] over the rows i with gid[i] == g

for ``gid [n]`` int32 in ``[0, G]`` and K value rows of ``[n]`` int32 (one
``[K, n]`` tensor, or a sequence of K tensors read where they lie), giving
``acc [K, G + 1]`` int32. Column ``G`` is the pad group the callers send
filtered rows to, and drop. The inputs are integers whose every sum fits
int32 (the route's chunks keep ``|row| * n < 2^31``), so any order of the
additions gives the same bits.

On a CUDA tensor ``grouped_sums`` launches the hand-written kernel
``csrc/grouped_sums.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version ``_grouped_sums_plain`` (one ``index_add_`` in int64).
``_plan`` chooses, by shape alone, where the kernel keeps the grid: in
shared memory whole in one block, cut into slices of value rows over
single blocks, or, where one row outgrows a block, spread over the two
blocks of a thread-block cluster; past that (one row wider than two
blocks' shared memory, only under raised group caps) in ``out`` itself,
by global atomics. Every ``(K, G)`` of the contract has a placement.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _cuda

MAX_ROWS = 64            # value-row pointers one launch takes (csrc MAX_ROWS)
SMEM_SM = 233_472        # shared memory of one H100 SM (228 KB)
SMEM_RESERVED = 1_024    # the runtime's share of it for each block
SMEM_BLOCK = 232_448     # the most one block may opt in to (227 KB)
THREADS_SM = 2_048
MAX_THREADS = 1_024
CLUSTERS = (1, 2)        # cluster sizes the plan takes (the kernel: 1-8)
BLOCKS_PER_SM = (8, 4, 2, 1)
GLOBAL = 0               # the `cluster` of the placement with the grid in out

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


class Launch(NamedTuple):
    """One launch of the kernel: value rows ``[k_lo, k_hi)`` of the call,
    in clusters of ``cluster`` blocks of ``threads`` threads, ``blocks`` in
    all; the rows cut into ``slices`` of ``rows`` rows, each block of a
    cluster owning ``width`` columns of its slice in shared memory.
    ``cluster == GLOBAL``: no shared memory, every block adds into ``out``
    (one slice of all the rows, ``width`` = G + 1)."""
    k_lo: int
    k_hi: int
    cluster: int
    slices: int
    rows: int
    width: int
    threads: int
    blocks: int

    @property
    def placement(self) -> str:
        if self.cluster == GLOBAL:
            return "global"
        if self.slices > 1:
            return "k_split"
        return "cluster" if self.cluster > 1 else "block"


def _model_occupancy(sms: int):
    """The card's co-resident clusters (blocks when C = 1 or GLOBAL) as the
    shared memory and thread limits of its SMs allow, ignoring how clusters
    are placed in GPCs (the card's own answer, on CUDA, replaces it)."""
    def occupancy(cluster: int, threads: int, smem: int) -> int:
        per_sm = min(THREADS_SM // threads, SMEM_SM // (smem + SMEM_RESERVED))
        return sms * per_sm // max(cluster, 1)
    return occupancy


def _budget(per_sm: int) -> int:
    """Shared memory a block may take when ``per_sm`` blocks share an SM."""
    return min(SMEM_BLOCK, SMEM_SM // per_sm - SMEM_RESERVED)


def _placement(n: int, k_lo: int, k: int, G: int, cluster: int, per_sm: int,
               occupancy) -> Optional[Launch]:
    """The launch that holds ``k <= MAX_ROWS`` value rows in clusters of
    ``cluster`` blocks, ``per_sm`` blocks an SM: each block owns
    ``ceil((G + 1) / cluster)`` columns of as many rows as its share of the
    SM's shared memory holds, the rows cut into as few slices as that
    allows; every slice gets the same number of clusters, as many as run at
    once (no more than the rows need). None if no row fits."""
    G1 = G + 1
    W = -(-G1 // cluster)
    fit = _budget(per_sm) // (4 * W)
    if fit < 1 or W * (cluster - 1) >= G1:
        return None                       # no row fits, or a block idles
    S = -(-k // fit)
    R = -(-k // S)
    threads = min(MAX_THREADS, THREADS_SM // per_sm)
    active = occupancy(cluster, threads, 4 * R * W)
    if active < 1:
        return None
    per_slice = max(1, min(active // S, -(-n // (cluster * threads))))
    return Launch(k_lo, k_lo + k, cluster, S, R, W, threads,
                  S * per_slice * cluster)


def _global_placement(n: int, k_lo: int, k: int, G: int,
                      occupancy) -> Launch:
    """The launch that adds ``k <= MAX_ROWS`` value rows straight into
    ``out`` (global atomics, no shared memory): two blocks of 1,024
    threads an SM, as many as run at once (no more than the rows need)."""
    threads = MAX_THREADS
    active = max(1, occupancy(GLOBAL, threads, 0))
    return Launch(k_lo, k_lo + k, GLOBAL, 1, k, G + 1, threads,
                  max(1, min(active, -(-n // threads))))


def _batch_plan(n: int, k_lo: int, k: int, G: int,
                occupancy) -> Launch:
    """The placement of ``k <= MAX_ROWS`` value rows, by shape (the rule
    and the H100 times behind it: PERF.md, section 6):

    1. the whole grid in one block, as many blocks an SM as hold it (each
       block a copy: copies spread the contention of a small grid);
    2. else the rows sliced over single blocks, two an SM where a row fits
       in half an SM: every add stays local, at one more read of gid a
       slice (a remote add costs about eight reads of a value);
    3. else a row spread over a cluster of two blocks, the rows sliced
       over the clusters;
    4. else (a row wider than two blocks' shared memory) global atomics
       into ``out``: clusters of four and eight were slower there, by up
       to 65%, but at one shape where they gained 2%."""
    G1 = G + 1
    steps = [(1, per_sm) for per_sm in BLOCKS_PER_SM
             if 4 * k * G1 <= _budget(per_sm)]
    steps += [(1, per_sm) for per_sm in (2, 1) if 4 * G1 <= _budget(per_sm)]
    steps += [(cluster, 1) for cluster in CLUSTERS[1:]]
    for cluster, per_sm in steps:
        launch = _placement(n, k_lo, k, G, cluster, per_sm, occupancy)
        if launch is not None:
            return launch
    return _global_placement(n, k_lo, k, G, occupancy)


def _plan(n: int, K: int, G: int, sms: int,
          occupancy=None) -> Tuple[Launch, ...]:
    """The launches for ``n`` rows, K value rows and G + 1 columns on a card
    of ``sms`` SMs: one a batch of at most MAX_ROWS value rows. By shape
    alone; ``occupancy(cluster, threads, smem)`` gives the co-resident
    clusters (default: ``_model_occupancy``)."""
    occupancy = occupancy or _model_occupancy(sms)
    return tuple(_batch_plan(n, k_lo, min(MAX_ROWS, K - k_lo), G, occupancy)
                 for k_lo in range(0, K, MAX_ROWS))


def _row_list(gid: torch.Tensor, rows: Rows, groups: int):
    """The value rows as a list of ``[n]`` tensors, after the contract's
    checks (raises on a mismatch of shape, dtype, device or layout)."""
    if gid.ndim != 1:
        raise ValueError(f"grouped_sums: want gid [n], got {tuple(gid.shape)}")
    n = gid.shape[0]
    if isinstance(rows, torch.Tensor):
        if rows.ndim != 2 or rows.shape[1] != n:
            raise ValueError("grouped_sums: want gid [n] and rows [K, n], got "
                             f"{tuple(gid.shape)}, {tuple(rows.shape)}")
        row_list = list(rows.unbind(0))
    else:
        row_list = list(rows)
        for r in row_list:
            if not isinstance(r, torch.Tensor) or r.ndim != 1 \
                    or r.shape[0] != n:
                raise ValueError(f"grouped_sums: want value rows of [{n}]")
    if gid.dtype != torch.int32 or any(r.dtype != torch.int32
                                       for r in row_list):
        raise TypeError("grouped_sums: want int32 gid and rows")
    if any(r.device != gid.device for r in row_list):
        raise ValueError("grouped_sums: inputs on different devices")
    if not (gid.is_contiguous() and all(r.is_contiguous() for r in row_list)):
        raise ValueError("grouped_sums: gid and rows must be contiguous")
    if groups < 0:
        raise ValueError(f"grouped_sums: want G >= 0, got {groups}")
    if len(row_list) * (groups + 1) >= 1 << 31:
        raise ValueError(f"grouped_sums: K * (G + 1) = "
                         f"{len(row_list) * (groups + 1)} does not fit int32")
    return row_list


def _grouped_sums_plain(gid: torch.Tensor, rows: Rows,
                        groups: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows (stacked here when
    given as a list) into int64 accumulators, cast to int32 (exact: every
    sum fits int32)."""
    if not isinstance(rows, torch.Tensor):
        rows = (torch.stack(list(rows)) if len(rows) else
                torch.zeros((0, gid.shape[0]), dtype=torch.int32,
                            device=gid.device))
    acc = torch.zeros((rows.shape[0], groups + 1), dtype=torch.int64,
                      device=rows.device)
    acc.index_add_(1, gid.to(torch.int64), rows.to(torch.int64))
    return acc.to(torch.int32)


def grouped_sums(gid: torch.Tensor, rows: Rows, groups: int) -> torch.Tensor:
    """``[K, G + 1]`` int32 sums of K value rows by ``gid [n]`` (see the
    module doc); ``rows`` is a ``[K, n]`` tensor or a sequence of K ``[n]``
    tensors, int32, contiguous and on gid's device. The kernel ignores a row
    whose id lies outside ``[0, G]``; the plain version raises on it."""
    row_list = _row_list(gid, rows, groups)
    if gid.device.type == "cpu":
        return _grouped_sums_plain(gid, rows, groups)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_sums: no kernel for {gid.device}")
    n = gid.shape[0]
    out = torch.zeros((len(row_list), groups + 1), dtype=torch.int32,
                      device=gid.device)
    if n == 0 or not row_list:
        return out
    lib = _launcher()
    with torch.cuda.device(gid.device):
        index = torch.cuda.current_device()
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for launch in _device_plan(index, n, len(row_list), groups):
            _launch(lib, gid, row_list[launch.k_lo:launch.k_hi],
                    out[launch.k_lo:launch.k_hi], launch, stream)
    return out


def _launch(lib, gid, rows, out, launch: Launch, stream) -> None:
    """One launch of the kernel under ``launch`` (rows and out cut to its
    value rows); raises if the launch is refused."""
    ptrs = (ctypes.c_void_p * len(rows))(*(r.data_ptr() for r in rows))
    err = lib.grouped_sums_launch(
        gid.data_ptr(), ptrs, out.data_ptr(), gid.shape[0], len(rows),
        out.shape[1], launch.cluster, launch.slices, launch.threads,
        launch.blocks, stream)
    if err:
        msg = lib.grouped_sums_error_string(err).decode()
        raise RuntimeError(f"grouped_sums launch failed ({launch}): {msg} "
                           f"({err})")
    grouped_sums.launches += 1


grouped_sums.launches = 0


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, n: int, K: int, G: int) -> Tuple[Launch, ...]:
    """``_plan`` for card ``index``, with its own occupancy answers."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _plan(n, K, G, sms, functools.partial(_occupancy, index))


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, cluster: int, threads: int, smem: int) -> int:
    """Co-resident clusters of ``cluster`` blocks on card ``index``, by
    ``cudaOccupancyMaxActiveClusters`` (blocks, when cluster is 1 or
    GLOBAL)."""
    lib = _launcher()
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.grouped_sums_occupancy(cluster, threads, smem,
                                         ctypes.byref(count))
    if err:
        msg = lib.grouped_sums_error_string(err).decode()
        raise RuntimeError(f"grouped_sums occupancy query failed: {msg} "
                           f"({err})")
    return count.value


# the C interface of csrc/grouped_sums.cu: gid, rows (a host array of device
# pointers), out; n, K, G + 1; cluster (GLOBAL: the grid in out), slices,
# threads, blocks; stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _cuda.load("grouped_sums")
    lib.grouped_sums_launch.argtypes = _LAUNCH_ARGTYPES
    lib.grouped_sums_launch.restype = ctypes.c_int
    lib.grouped_sums_occupancy.argtypes = [ctypes.c_int] * 3 \
        + [ctypes.POINTER(ctypes.c_int)]
    lib.grouped_sums_occupancy.restype = ctypes.c_int
    lib.grouped_sums_error_string.argtypes = [ctypes.c_int]
    lib.grouped_sums_error_string.restype = ctypes.c_char_p
    return lib
