"""The least time of the approximate route's two steps on one H100, at the
peaks of ``peaks.py``, and the route's shapes as the cell states them.

``flash_bound`` is a frozen copy of ``chip_smoke.py``'s ``flash_bound``:
later changes to the port or to ``chip_smoke.py`` do not move the
benchmark's ``flash_minima_roofline``. Every shape comes from the traced
record's configuration (its ``approx`` sizes, ``rows``, ``dim``, ``k``)
and traffic mix, never from the port.
"""

from __future__ import annotations

from . import peaks


def flash_bound(b: int, n: int, d: int, tile: int, lanes: int) -> tuple:
    """(seconds, "bytes" or "operations"): the least time of one
    ``flash_group_minima`` launch over ``b`` queries and ``n`` padded rows
    of ``d`` columns: one read of the f32 queries, the bf16 corpus and its
    f32 norms plus one write of the ``[n / tile, b, lanes]`` f32 minima at
    the memory rate, or its ``2 b n d`` bf16 FLOPs at the tensor-core peak,
    whichever is larger."""
    nbytes = 4 * b * d + 2 * n * d + 4 * n + 4 * (n // tile) * b * lanes
    return peaks.bound(nbytes, 2.0 * b * n * d / peaks.BF16_FLOPS_PER_S)


def rerank_bound(b: int, n: int, d: int, tile: int, lanes: int,
                 shortlist: int, k: int) -> tuple:
    """(seconds, "bytes"): the least time of one chunk's re-rank: one read
    of the ``[n / tile, b, lanes]`` f32 minima and of the ``b * shortlist
    * tile / lanes`` shortlisted f32 rows of ``d`` columns, and one write
    of the ``[b, k]`` f32 distances and int64 ids."""
    rows = b * shortlist * (tile // lanes)
    nbytes = 4 * (n // tile) * b * lanes + 4 * rows * d + 12 * b * k
    return nbytes / peaks.HBM_BYTES_PER_S, "bytes"


def shapes(record) -> dict | None:
    """The route's shapes from a traced record's ``config`` and ``mix``:
    ``b`` queries a chunk, ``chunks`` a batch, ``n`` rows padded to whole
    tiles, ``d`` columns padded to a multiple of 16, ``tile``, ``lanes``,
    ``shortlist`` groups and ``k``; None where the record has no
    approximate route."""
    config, mix = record.get("config"), record.get("mix")
    if not config or not mix or "approx" not in config:
        return None
    a = config["approx"]
    tile = a["tile"]
    return {"b": min(a["query_chunk"], mix["batch"]),
            "chunks": -(-mix["batch"] // a["query_chunk"]),
            "n": -(-config["rows"] // tile) * tile,
            "d": -(-config["dim"] // 16) * 16,
            "tile": tile, "lanes": a["lanes"],
            "shortlist": a["shortlist_groups"], "k": config["k"]}
