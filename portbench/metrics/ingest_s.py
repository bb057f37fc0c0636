"""``ingest_s``: seconds of the benchmark's ``insert`` span, one
``insert_block`` of every row. Layer: Fuse storage
(``storage/fuse/table.py``, ``block_io.py``)."""


def read(record):
    return record.get("spans", {}).get("insert")
