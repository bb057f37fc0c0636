"""``exact_select_roofline``: ``exact_topk_select``'s share of its
roofline. The least time of one launch at the chunk's shape (``b`` and
``N`` from the traced window's most common ``aten::mm``, ``k`` the
configuration's; ``peaks.exact_select_bound``, l2) over the kernel's mean
device time a launch (its name in the trace: ``block_kernel``). Layer: ops,
``ops/exact_topk.py`` and ``csrc/exact_topk_select.cu``."""

from collections import Counter

from portbench import peaks
from portbench.devtrace import in_window, products

KERNEL = "block_kernel"


def read(record):
    if not record.get("window_us"):
        return None
    mms = products(record)
    times = [e - s for name, s, e in in_window(record["device"],
                                                 record["window_us"])
             if KERNEL in name]
    if not mms or not times:
        return None
    b, _, n = Counter(mms).most_common(1)[0][0]
    least, _ = peaks.exact_select_bound(b, n, record["config"]["k"])
    return 100.0 * least / (sum(times) / len(times) / 1e6)
