"""Device finalize fusion (reference ``pipeline/device_fusion.py``): not
ported yet, ROADMAP item 12.

Only the request type is here: the executor builds a :class:`Fusion` for
HAVING / ORDER BY ... LIMIT above an Aggregate and offers it to the device
routes, which decline it in the port (``device_scan_agg``,
``device_join_agg``), so the host finishes the query.
"""

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class Fusion:
    """What the plan nodes above the Aggregate want applied to the grid.
    ``order`` names and ``having`` columns refer to the AGGREGATE's
    output names (group keys + agg outputs)."""
    having: Optional[Any] = None                 # ScalarExpr
    order: List[Tuple[str, bool, Optional[bool]]] = field(
        default_factory=list)                    # (name, asc, nulls_first)
    limit: Optional[int] = None
