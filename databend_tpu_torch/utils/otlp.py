"""OTLP/JSON span export (reference: src/common/tracing/src/init.rs:29-182
— fastrace spans exported over OTLP grpc/http).

Zero-egress image, so the exporter writes OTLP-shaped JSON
(ExportTraceServiceRequest: resourceSpans -> scopeSpans -> spans with
hex trace/span ids and unix-nano timestamps) to a local NDJSON file set
by the ``otlp_export_path`` setting — the same payloads an OTLP/HTTP
collector would receive; pointing a real endpoint at it is a transport
swap, not a format change.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional

_SERVICE = "databend-tpu-query"


def _hex_id(*parts, width: int) -> str:
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(),
                        digest_size=width // 2)
    return h.hexdigest()


def spans_to_otlp(spans, wall_anchor: Optional[float] = None) -> dict:
    """OTLP ExportTraceServiceRequest JSON for a span list. Spans carry
    perf_counter times; ``wall_anchor`` maps them onto the unix clock
    (defaults to "now = latest span end")."""
    if wall_anchor is None:
        latest = max((s.end for s in spans), default=0.0)
        wall_anchor = time.time() - latest
    out = []
    for s in spans:
        start_ns = int((wall_anchor + s.start) * 1e9)
        end_ns = int((wall_anchor + s.end) * 1e9)
        span_id = _hex_id(s.query_id, s.path(), s.start, width=16)
        parent_id = "" if s.parent is None else _hex_id(
            s.query_id, s.parent.path(), s.parent.start, width=16)
        attrs = [{"key": k, "value": {"stringValue": str(v)}}
                 for k, v in (s.attrs or {}).items()]
        attrs.append({"key": "query_id",
                      "value": {"stringValue": s.query_id}})
        out.append({
            "traceId": _hex_id(s.query_id, width=32),
            "spanId": span_id,
            "parentSpanId": parent_id,
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": attrs,
        })
    return {
        "resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": _SERVICE}}]},
            "scopeSpans": [{
                "scope": {"name": "databend_tpu.utils.tracing"},
                "spans": out,
            }],
        }]
    }


def export_query_spans(session, query_id: str) -> None:
    """Append one OTLP JSON request per query to the configured path.
    No-op unless the ``otlp_export_path`` setting is non-empty."""
    try:
        path = str(session.settings.get("otlp_export_path") or "")
    except Exception:
        return
    if not path:
        return
    from .tracing import RECORDER
    spans = [s for s in RECORDER.snapshot() if s.query_id == query_id]
    if not spans:
        return
    payload = spans_to_otlp(spans)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(payload) + "\n")
