"""``launches_per_batch``: device items (kernels, copies, memsets) the card
ran in the traced window, per batch. Layer: prepared KNN serving
(``service/prepared.py``, ``_KnnServer``: the chunk loop and what it
launches around it)."""

from portbench.devtrace import in_window


def read(record):
    if not record.get("window_us") or not record.get("batches"):
        return None
    items = in_window(record["device"], record["window_us"])
    return len(items) / record["batches"] if items else None
