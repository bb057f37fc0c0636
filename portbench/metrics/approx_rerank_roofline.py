"""``approx_rerank_roofline``: the approximate route's re-rank's share of
its roofline. The least time of one chunk's re-rank
(``approx_bounds.rerank_bound``: one read of the group minima and of the
shortlisted f32 rows, one write of the ``[b, k]`` answer; the shapes from
the record's configuration and mix) over the device time a chunk of every
item in the traced window other than ``flash_group_minima_kernel``, the
copies and the memsets: the shortlist, its expansion, the gather, the f32
distances, the selection and the small steps around them. A chunk is one
launch of the flash kernel. Layer: ops, the flash re-rank
(``ops/flash_topk.flash_rerank``)."""

from portbench.approx_bounds import rerank_bound, shapes
from portbench.devtrace import in_window

KERNEL = "flash_group_minima_kernel"
NOT_COMPUTE = ("Memcpy", "Memset")


def read(record):
    if not record.get("window_us") or not record.get("device"):
        return None
    sh = shapes(record)
    items = in_window(record["device"], record["window_us"])
    chunks = sum(1 for name, _, _ in items if KERNEL in name)
    rest = [e - s for name, s, e in items
            if KERNEL not in name and not name.startswith(NOT_COMPUTE)]
    if sh is None or not chunks or not rest:
        return None
    least, _ = rerank_bound(sh["b"], sh["n"], sh["d"], sh["tile"],
                            sh["lanes"], sh["shortlist"], sh["k"])
    return 100.0 * least / (sum(rest) / chunks / 1e6)
