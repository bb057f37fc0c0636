"""``knn_rerank_ms``: ms a batch of the port's ``knn_rerank`` span: the
host's enqueue of each query chunk's re-rank on the flash route (the
shortlist, its expansion, the f32 gather, distances and selection), the
most of ``knn_launch`` there. Layer: prepared KNN serving
(``service/prepared.py`` ``_KnnServer._flash_select``,
``ops/flash_topk.flash_rerank``)."""

from portbench.port_spans import ms_a_batch


def read(record):
    return ms_a_batch(record, ("knn_rerank",))
