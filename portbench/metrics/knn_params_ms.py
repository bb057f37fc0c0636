"""``knn_params_ms``: ms a batch of the port's ``knn_params`` span: the
parameter sets turned into the checked query matrix
(``PreparedStatement._as_query_matrix``, ``_check_queries``). Layer:
prepared KNN serving (``service/prepared.py``)."""

from portbench.port_spans import ms_a_batch


def read(record):
    return ms_a_batch(record, ("knn_params",))
