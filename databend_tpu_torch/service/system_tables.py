"""System tables: the reference ``service/system_tables.py`` with the two
tables that describe the devices, ``system.build_options`` and
``system.clusters``, reading them from torch (``backend.devices``)."""

import torch

from .._reference import exec_reference
from .. import backend

exec_reference(globals(), "service/system_tables.py")


def _sys_build_options(s):
    from ..version import __version__
    devs = backend.devices()
    return _block([  # noqa: F821
        ("name", String, ["version", "torch_version", "device_platform",  # noqa: F821
                          "device_count"]),
        ("value", String, [__version__, torch.__version__,  # noqa: F821
                           ",".join(sorted({d.type for d in devs})),
                           str(len(devs))])])


def _sys_clusters(s):
    """Registered server processes (reference clusters_table: query nodes
    from ClusterDiscovery) plus the devices as the data-plane rows."""
    rows = []
    try:
        from ..meta.cluster import ClusterDiscovery
        for n in ClusterDiscovery(s.meta).list_nodes():
            rows.append((n.node_id, n.address, f"server v{n.version} "
                         f"({n.device_count} devices)", 0))
    except Exception:
        pass
    rows += [(f"device-{i}", d.type, str(d), i)
             for i, d in enumerate(backend.devices())]
    cols = list(zip(*rows)) if rows else [[] for _ in range(4)]
    return _block([  # noqa: F821
        ("name", String, list(cols[0])), ("host", String, list(cols[1])),  # noqa: F821
        ("description", String, list(cols[2])),  # noqa: F821
        ("port", Int64, list(cols[3]))])  # noqa: F821


SYSTEM_TABLES["build_options"] = _sys_build_options  # noqa: F821
SYSTEM_TABLES["clusters"] = _sys_clusters  # noqa: F821
