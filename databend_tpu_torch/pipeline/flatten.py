"""FLATTEN: explode semi-structured values into rows.

Reference: the FLATTEN table function over variant documents
(src/query/service/src/table_functions/srf/flatten — seq/key/path/index/
value/this output schema, path =>, outer =>, recursive =>, mode =>).

The explode itself is host-side (variant never enters device kernels);
the surrounding query pipeline treats the output like any other block
stream, so downstream aggregation/joins still ride the jitted paths.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

from ..errors import BadArguments

# one output element: (key, path, index, value, this)
FlatRow = Tuple[Optional[str], Optional[str], Optional[int], Any, Any]


def _walk(doc: Any, base: str, mode: str, recursive: bool,
          out: List[FlatRow]) -> None:
    if isinstance(doc, list) and mode in ("array", "both"):
        for i, v in enumerate(doc):
            p = f"{base}[{i}]"
            out.append((None, p, i, v, doc))
            if recursive and isinstance(v, (list, dict)):
                _walk(v, p, mode, recursive, out)
    elif isinstance(doc, dict) and mode in ("object", "both"):
        for k, v in doc.items():
            p = f"{base}.{k}" if base else k
            out.append((k, p, None, v, doc))
            if recursive and isinstance(v, (list, dict)):
                _walk(v, p, mode, recursive, out)


def _get_path(doc: Any, path: str) -> Any:
    """Navigate 'a.b[2].c' into a parsed document."""
    cur = doc
    token = ""
    i = 0
    parts: List[Any] = []
    while i < len(path):
        ch = path[i]
        if ch == ".":
            if token:
                parts.append(token)
                token = ""
        elif ch == "[":
            if token:
                parts.append(token)
                token = ""
            j = path.index("]", i)
            parts.append(int(path[i + 1:j]))
            i = j
        else:
            token += ch
        i += 1
    if token:
        parts.append(token)
    for p in parts:
        if isinstance(p, int):
            cur = cur[p] if isinstance(cur, list) and p < len(cur) else None
        else:
            cur = cur.get(p) if isinstance(cur, dict) else None
        if cur is None:
            return None
    return cur


def flatten_value(raw: Any, path: str = "", mode: str = "both",
                  recursive: bool = False, outer: bool = False,
                  is_json_text: bool = True) -> List[FlatRow]:
    """Explode one input value. `raw` is JSON text (variant) or an
    already-parsed python list/dict (typed ARRAY column)."""
    mode = (mode or "both").lower()
    if mode not in ("object", "array", "both"):
        raise BadArguments(f"flatten mode must be OBJECT/ARRAY/BOTH, "
                           f"got {mode!r}")
    doc = raw
    if raw is not None and is_json_text and isinstance(raw, (str, bytes)):
        try:
            doc = json.loads(raw)
        except Exception:
            doc = None
    if doc is not None and path:
        doc = _get_path(doc, path)
    out: List[FlatRow] = []
    if doc is not None:
        _walk(doc, path, mode, recursive, out)
    if not out and outer:
        out.append((None, None, None, None, None))
    return out


def to_json_or_none(v: Any) -> Optional[str]:
    return None if v is None else json.dumps(v, separators=(",", ":"),
                                             default=str)
