"""``load_s``: seconds from ``prepare`` to the end of the first answered
batch (the benchmark's ``prepare`` and ``load`` spans): the corpus stacked
and uploaded at the first query. Layer: Fuse storage and the serving load
(``FuseTable.stacked_device_vectors``, ``_KnnServer.refresh``)."""


def read(record):
    spans = record.get("spans", {})
    if "prepare" not in spans or "load" not in spans:
        return None
    return spans["prepare"] + spans["load"]
