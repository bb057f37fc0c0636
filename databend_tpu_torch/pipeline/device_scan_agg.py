"""Device scan-aggregate route (reference ``pipeline/device_scan_agg.py``):
not ported yet, ROADMAP item 12.

The reference runs an eligible Aggregate(Scan) as one device program over
device-resident table columns. Until the port has that program the route
declines every plan, exactly as the reference does when
``enable_device_local_execution`` is off, and the executor's host
aggregation answers it.
"""

from typing import Optional


def try_device_scan_agg(plan, fusion=None) -> Optional[object]:
    """Decline the device route: None hands the plan to the host."""
    return None
