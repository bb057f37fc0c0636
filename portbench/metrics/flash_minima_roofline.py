"""``flash_minima_roofline``: ``flash_group_minima``'s share of its
roofline. The least time of one launch at the cell's chunk
(``approx_bounds.flash_bound``: one read of the queries, the bf16 corpus
and its norms and one write of the group minima, or the bf16 product's
FLOPs at the tensor-core peak, whichever is larger; the shapes from the
record's configuration and mix) over the kernel's mean device time a launch
in the traced window (its name in the trace: ``flash_group_minima_kernel``).
Layer: ops, ``ops/flash_topk.py`` and ``csrc/flash_group_minima.cu``."""

from portbench.approx_bounds import flash_bound, shapes
from portbench.devtrace import in_window

KERNEL = "flash_group_minima_kernel"


def read(record):
    if not record.get("window_us") or not record.get("device"):
        return None
    sh = shapes(record)
    times = [e - s for name, s, e in in_window(record["device"],
                                                 record["window_us"])
             if KERNEL in name]
    if sh is None or not times:
        return None
    least, _ = flash_bound(sh["b"], sh["n"], sh["d"], sh["tile"], sh["lanes"])
    return 100.0 * least / (sum(times) / len(times) / 1e6)
