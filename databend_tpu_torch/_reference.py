"""Load the reference package's host-only source into the port.

The port is an overlay of ``databend_tpu``: a module the port does not
provide is found in the reference directory and imported under a
``databend_tpu_torch.*`` name, so its relative imports resolve into the port
(own registries, caches and device seams). Two helpers make that work for a
subpackage or module the port partly overrides:

* :func:`overlay_package` appends the reference directory to a port
  subpackage's ``__path__`` and runs the reference ``__init__`` source in it;
* :func:`exec_reference` runs a reference module's source in a port module's
  namespace, after which the port module redefines only its device seams
  (or, for a line that names the reference package, substitutes that line's
  text before the source runs).

The reference files are read by path: the ``databend_tpu`` package itself is
never imported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

PORT_DIR = os.path.dirname(os.path.abspath(__file__))
REFERENCE_DIR = os.path.join(os.path.dirname(PORT_DIR), "databend_tpu")


def reference_path(relpath: str) -> str:
    """Absolute path of ``relpath`` (``"storage/fuse/table.py"``) in the
    reference package."""
    return os.path.join(REFERENCE_DIR, *relpath.split("/"))


def exec_reference(namespace: dict, relpath: str,
                   replace: Optional[Dict[str, str]] = None) -> None:
    """Execute the reference module ``relpath`` in ``namespace`` (a port
    module's ``globals()``). ``__name__`` and ``__package__`` stay the
    port's, so relative imports resolve into the port. ``replace`` maps
    source text to its substitute; each key must occur exactly once."""
    path = reference_path(relpath)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    for old, new in (replace or {}).items():
        if src.count(old) != 1:
            raise ImportError(f"{relpath}: {old!r} occurs {src.count(old)} "
                              "times, want 1")
        src = src.replace(old, new)
    doc = namespace.get("__doc__")
    exec(compile(src, path, "exec", dont_inherit=True), namespace)
    if doc is not None:   # keep the port module's own docstring
        namespace["__doc__"] = doc


def overlay_package(namespace: dict, subpackage: str) -> None:
    """Make a port subpackage an overlay of ``subpackage`` (``"storage/fuse"``):
    modules the port lacks load from the reference directory, and the
    reference ``__init__`` runs with the port's modules in front."""
    namespace["__path__"].append(reference_path(subpackage))
    exec_reference(namespace, f"{subpackage}/__init__.py")
