"""``knn_launch_ms``: ms a batch of the port's ``knn_launch`` span: the
host's enqueue of every query chunk's product, selection and re-score
(``_scan_topk_program``). Layer: prepared KNN serving
(``service/prepared.py``, ``storage/fuse/table._exact_topk_program``)."""

from portbench.port_spans import ms_a_batch


def read(record):
    return ms_a_batch(record, ("knn_launch",))
