"""Device join-aggregate route (reference ``pipeline/device_join_agg.py``):
not ported yet, ROADMAP item 12.

The reference answers an Aggregate over equi-joins on the device
(dictionary enrichment, aggregate pushdown). Until the port has those
programs the route declines every plan, as the reference does when
``enable_device_local_execution`` is off, and the host join and
aggregation answer it.
"""

from typing import Optional


def try_device_join_agg(plan, fusion=None) -> Optional[object]:
    """Decline the device route: None hands the plan to the host."""
    return None
