"""Device and the numpy <-> device boundary of the port.

Tensors live on ``cuda``. ``cpu`` is used only when it is asked for by name
(the CPU tests set ``DATABEND_TORCH_DEVICE=cpu``); a machine without a card
that did not ask for it gets an error, never a silent CPU run.

float32 matrix products stay full float32: the reference computes f32
distances at ``Precision.HIGHEST`` (``databend_tpu/ops/distance.py``), and
TF32 would keep only about three decimal digits.
"""

from __future__ import annotations

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICE_ENV = "DATABEND_TORCH_DEVICE"


def device() -> torch.device:
    """The port's device: ``$DATABEND_TORCH_DEVICE`` when set, else cuda."""
    name = os.environ.get(DEVICE_ENV)
    if name:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "databend_tpu_torch needs a CUDA device; set "
            f"{DEVICE_ENV}=cpu to run on the CPU on purpose")
    return torch.device("cuda")


_device = device     # the module function, under a parameter of that name


def devices() -> list:
    """Every device the port runs on: all cards under cuda, else the one
    device asked for by name."""
    dev = device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def identity() -> dict:
    """What a query node registers about its devices (the meta registry's
    ``NodeInfo.extra``): the device kind and, under cuda, the UUIDs of the
    cards this process sees, comma-separated. The multi-process mesh's
    backend rule reads them (``parallel.multihost.choose_backend``)."""
    dev = device()
    out = {"device": dev.type}
    if dev.type == "cuda":
        out["cards"] = ",".join(
            str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count()))
    return out


def to_device(array, dtype: torch.dtype = None,
              device: torch.device = None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device`` (a mesh position's
    device), by default :func:`device`."""
    # torch wants a writable buffer: copy only read-only or strided input
    t = torch.from_numpy(np.require(array, requirements=["C", "W"]))
    return t.to(device=device if device is not None else _device(),
                dtype=dtype)


def to_numpy(tensors):
    """Tensor -> numpy array; a list or tuple of tensors -> a list of arrays,
    fetched with ONE device->host copy when every tensor has 4-byte elements
    (they travel as one int32 buffer and are split and re-typed on the
    host)."""
    if isinstance(tensors, torch.Tensor):
        return tensors.detach().cpu().numpy()
    if not tensors:
        return []
    if any(t.element_size() != 4 for t in tensors):
        return [t.detach().cpu().numpy() for t in tensors]
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.int32)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[off:off + n].view(np_dtype).reshape(tuple(t.shape)))
        off += n
    return out
