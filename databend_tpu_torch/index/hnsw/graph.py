"""HNSW graph container: the reference's numpy-only ``index/hnsw/graph.py``,
run in the port's namespace."""

from ..._reference import exec_reference

exec_reference(globals(), "index/hnsw/graph.py")
