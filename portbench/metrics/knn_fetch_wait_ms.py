"""``knn_fetch_wait_ms``: ms a batch of the port's ``knn_fetch`` span: the
host blocked on the card until the batch's results are done, then their
copy to host memory (``backend.to_numpy``). Layer: the device, as the host
waits on it."""

from portbench.port_spans import ms_a_batch


def read(record):
    return ms_a_batch(record, ("knn_fetch",))
