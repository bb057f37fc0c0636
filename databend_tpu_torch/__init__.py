"""databend_tpu_torch — the PyTorch/CUDA port of ``databend_tpu``.

An overlay package: ``__path__`` lists this directory first and the
reference ``databend_tpu`` directory second, so host-only modules (parser,
binder, planner, executor, Fuse storage, meta) load from the reference
source under ``databend_tpu_torch.*`` names, while the modules that touch the
device are the port's own (``ops``, the vector seams of ``storage.fuse.table``,
``service.prepared``, ...). The port imports ``torch``; device choice lives
in :mod:`databend_tpu_torch.backend`. Its own modules never import ``jax``
or the ``databend_tpu`` package, and the relational device routes decline
to the host. Two features not ported yet still reach reference JAX code
through the overlay: CLUSTER BY over a vector column (``index/kmeans.py``)
and the device BM25 scorer (``index/inverted/device.py``); see ROADMAP.md.
"""

import os as _os

__path__ = [_os.path.dirname(_os.path.abspath(__file__)),
            _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), "databend_tpu")]

from .version import __version__  # noqa: E402

__all__ = ["__version__", "SessionContext"]


def __getattr__(name):
    # Lazy import: keep `import databend_tpu_torch` light until used.
    if name == "SessionContext":
        from .service.session import SessionContext
        return SessionContext
    raise AttributeError(name)
