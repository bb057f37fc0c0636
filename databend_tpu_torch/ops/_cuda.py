"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
repository root (the file name carries a hash of the source, so an edited
kernel is rebuilt) and loaded with ``ctypes``. Nothing here runs at import
time; a machine without ``nvcc`` fails only when a kernel is first launched.
A compile is a ``kernel_build`` span and counts in the ``kernel_builds`` and
``kernel_build_seconds`` metrics.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils.metrics import METRICS
from ..utils.tracing import span

PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PORT_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PORT_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lcuda")   # cuTensorMapEncodeTiled (TMA tensor maps)

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns
    ``{"path", "seconds", "log"}`` (``log`` holds ``-Xptxas -v`` output,
    kept beside the library for later calls; ``seconds`` is 0 then)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        with open(out + ".log") as f:
            return {"path": out, "seconds": 0.0, "log": f.read()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    with span("kernel_build", kernel=name) as s:
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
        s.attrs["seconds"] = seconds = time.perf_counter() - t0
    METRICS.inc("kernel_builds")
    METRICS.inc("kernel_build_seconds", seconds)
    return {"path": out, "seconds": seconds, "log": log}


@functools.cache
def sm_count(device) -> int:
    """The SMs of the card ``device`` (a launch plan fills them)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _LIBS[name] = lib
        return lib
