"""HNSW in the port.

``HnswGraph`` is the reference's numpy-only container (``graph.py``). The
graph build and beam search are JAX programs in the reference and are not
ported yet (ROADMAP.md, "Modules to port": HNSW); the port has no
``build.py`` or ``search.py``.
Tables index blocks of up to 2^20 rows without a graph (``graphs='auto'``)
and serve them with the exact scan, so the exact-KNN path never calls these.
"""

from .graph import HnswGraph

_NOT_PORTED = ("HNSW {} is not ported to databend_tpu_torch yet "
               "(ROADMAP.md, 'Modules to port': HNSW)")


def build_hnsw(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("graph build"))


def hnsw_search(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("search"))


__all__ = ["HnswGraph", "build_hnsw", "hnsw_search"]
