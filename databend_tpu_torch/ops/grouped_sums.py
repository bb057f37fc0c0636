"""Grouped integer sums of the device scan-aggregate route.

The reference's grouping engines (``databend_tpu/pipeline/device_scan_agg.py``,
``_build_program``: the "mask" engine's G x K masked sums and the "matmul"
engine's one-hot int8 product) are XLA programs; both compute one function::

    acc[k, g] = sum of rows[k, i] over the rows i with gid[i] == g

for ``gid [n]`` int32 in ``[0, G]`` and ``rows [K, n]`` int32, giving
``acc [K, G + 1]`` int32. Column ``G`` is the pad group the callers send
filtered rows to, and drop. The inputs are integers whose every sum fits
int32 (the route's chunks keep ``|row| * n < 2^31``), so any order of the
additions gives the same bits.

On a CUDA tensor ``grouped_sums`` launches the hand-written kernel
``csrc/grouped_sums.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version ``_grouped_sums_plain`` (one ``index_add_`` in int64).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda


def _check_inputs(gid: torch.Tensor, rows: torch.Tensor, groups: int) -> None:
    if gid.ndim != 1 or rows.ndim != 2 or rows.shape[1] != gid.shape[0]:
        raise ValueError("grouped_sums: want gid [n] and rows [K, n], got "
                         f"{tuple(gid.shape)}, {tuple(rows.shape)}")
    if gid.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("grouped_sums: want int32 gid and rows")
    if gid.device != rows.device:
        raise ValueError("grouped_sums: inputs on different devices")
    if groups < 0:
        raise ValueError(f"grouped_sums: want G >= 0, got {groups}")


def _grouped_sums_plain(gid: torch.Tensor, rows: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the rows into int64
    accumulators, cast to int32 (exact: every sum fits int32)."""
    acc = torch.zeros((rows.shape[0], groups + 1), dtype=torch.int64,
                      device=rows.device)
    acc.index_add_(1, gid.to(torch.int64), rows.to(torch.int64))
    return acc.to(torch.int32)


def grouped_sums(gid: torch.Tensor, rows: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """``[K, G + 1]`` int32 sums of ``rows [K, n]`` by ``gid [n]`` (see the
    module doc). The kernel ignores a row whose id lies outside ``[0, G]``;
    the plain version raises on it."""
    _check_inputs(gid, rows, groups)
    if gid.device.type == "cpu":
        return _grouped_sums_plain(gid, rows, groups)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_sums: no kernel for {gid.device}")
    if not (gid.is_contiguous() and rows.is_contiguous()):
        raise ValueError("grouped_sums: gid and rows must be contiguous")
    n_rows, n_sums = gid.shape[0], rows.shape[0]
    if n_sums * (groups + 1) >= 1 << 31:
        raise ValueError(f"grouped_sums: K * (G + 1) = {n_sums * (groups + 1)}"
                         " does not fit int32")
    out = torch.zeros((n_sums, groups + 1), dtype=torch.int32,
                      device=gid.device)
    if n_rows == 0 or n_sums == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        err = lib.grouped_sums_launch(gid.data_ptr(), rows.data_ptr(),
                                      out.data_ptr(), n_rows, n_sums,
                                      groups + 1, stream)
    if err:
        msg = lib.grouped_sums_error_string(err).decode()
        raise RuntimeError(f"grouped_sums launch failed: {msg} ({err})")
    grouped_sums.launches += 1
    return out


grouped_sums.launches = 0

# the C interface of csrc/grouped_sums.cu: gid, rows, out; n, K, G + 1; stream
_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


@functools.cache
def _launcher() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _cuda.load("grouped_sums")
    lib.grouped_sums_launch.argtypes = _LAUNCH_ARGTYPES
    lib.grouped_sums_launch.restype = ctypes.c_int
    lib.grouped_sums_error_string.argtypes = [ctypes.c_int]
    lib.grouped_sums_error_string.restype = ctypes.c_char_p
    return lib
