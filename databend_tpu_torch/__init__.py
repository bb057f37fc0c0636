"""databend_tpu_torch — the PyTorch/CUDA port of ``databend_tpu``.

A package of its own beside the JAX reference: it holds its own copy of
every host layer it uses (parser, binder, planner, executor, Fuse storage,
meta, servers), and its device layers run on torch, with the hand-written
CUDA kernels under ``csrc/``. Device choice lives in
:mod:`databend_tpu_torch.backend`. The port never imports ``jax`` or the
``databend_tpu`` package and reads none of its files;
``tests/test_torch_standalone.py`` checks that every copied host module is
still byte-identical to its reference, apart from a named list of modules
the port owns. Every reference module has its counterpart. A mesh spans
query processes through ``parallel/multihost.join_cluster_mesh``: the nodes
registered in the meta service join one ``torch.distributed`` process
group (gloo on the CPU, NCCL when each process has cards of its own, gloo
through host memory when processes share a card) and each process holds
the mesh positions of its own devices.
"""

from .version import __version__

__all__ = ["__version__", "SessionContext"]


def __getattr__(name):
    # Lazy import: keep `import databend_tpu_torch` light until used.
    if name == "SessionContext":
        from .service.session import SessionContext
        return SessionContext
    raise AttributeError(name)
