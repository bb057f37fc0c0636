"""Overlay of ``databend_tpu/storage``: the port's modules first, the
reference's host modules after them (see ``_reference.py``)."""

from .._reference import overlay_package

overlay_package(globals(), "storage")
