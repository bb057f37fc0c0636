"""``knn_result_ms``: ms a batch of the port's ``knn_take`` and
``knn_block`` spans: the projection's gather of the winners' rows and the
result block built from them. Layer: prepared KNN serving
(``service/prepared.py``)."""

from portbench.port_spans import ms_a_batch


def read(record):
    return ms_a_batch(record, ("knn_take", "knn_block"))
