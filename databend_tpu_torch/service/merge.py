"""MERGE INTO: the reference ``service/merge.py``, with its one absolute
import of the reference binder (``databend_tpu.sql.binder``, for
``ScanState``) pointed at the port's own binder, so a MERGE never loads the
reference package."""

from .._reference import exec_reference

exec_reference(globals(), "service/merge.py", replace={
    '"databend_tpu.sql.binder"': '__package__.rpartition(".")[0] + ".sql.binder"'})
