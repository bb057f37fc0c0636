"""Exchange operators of the port: names only (ROADMAP.md item 11b).

The reference's exchanges are ``shard_map`` programs over a mesh. The
executor imports these names before it asks ``get_default_mesh()`` for a
mesh, gets None, and runs the host operator, so none of them is called. Each
raises if it ever is: a caller that holds a mesh needs the real exchange.
"""

from __future__ import annotations


def _not_ported(name: str):
    def decline(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.exchange.{name} is not ported to databend_tpu_torch "
            "(ROADMAP.md item 11b: mesh and exchanges); "
            "get_default_mesh() returns None, so the host operator answers")
    decline.__name__ = name
    return decline


range_partition_sort = _not_ported("range_partition_sort")
sharded_topn = _not_ported("sharded_topn")
sharded_grouped_agg = _not_ported("sharded_grouped_agg")
sharded_shuffle_grouped_agg = _not_ported("sharded_shuffle_grouped_agg")
broadcast_lookup_join = _not_ported("broadcast_lookup_join")
shuffle_by_key = _not_ported("shuffle_by_key")


class ShuffleJoin:
    """Shuffle join context of the reference; building one needs a mesh."""

    def __init__(self, *args, **kwargs):
        _not_ported("ShuffleJoin")()
