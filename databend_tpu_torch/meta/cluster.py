"""Cluster membership: the reference ``meta/cluster.py`` with
``ClusterDiscovery.local_node`` counting the port's devices
(``backend.devices``)."""

from .._reference import exec_reference
from .. import backend

exec_reference(globals(), "meta/cluster.py")


def local_node(address: str = "", cluster_id: str = "default") -> NodeInfo:  # noqa: F821
    from ..version import __version__
    return NodeInfo(  # noqa: F821
        node_id=f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}",  # noqa: F821
        address=address, version=__version__,
        cpu_count=os.cpu_count() or 1,  # noqa: F821
        device_count=len(backend.devices()),
        cluster_id=cluster_id)


ClusterDiscovery.local_node = staticmethod(local_node)  # noqa: F821
