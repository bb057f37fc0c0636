"""``device_idle_share``: the share of the traced window in which no item
ran on the card, by the union of its busy intervals (items that overlap
count once). Layer: the device (the H100, all streams)."""

from portbench.devtrace import busy_us


def read(record):
    w = record.get("window_us")
    if not w or w[1] <= w[0] or not record.get("device"):
        return None
    return 100.0 * (1.0 - busy_us(record) / (w[1] - w[0]))
