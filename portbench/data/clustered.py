"""Clustered vectors made on the device from the seed: the rows of a table
and a pool of queries drawn alike.

A frozen copy of ``chip_smoke.py``'s ``sift_like``, rewritten for a
``torch.Generator`` on the card and made general: ``centres`` centres drawn
uniformly in ``[centre_low, centre_high)`` (whole numbers where
``integer``), each row a centre chosen uniformly plus normal noise of
``noise_sd``, rounded to a whole number where ``integer``, then clipped to
``[clip_low, clip_high]``. SIFT1M's shape is ``sift_like`` as it was: 1,000
whole-number centres in [0, 255], noise 24, whole numbers in [0, 255]. The
GIST-like rows are the same construction without rounding (the sizes are
the configuration's ``assumed``).

``make`` returns the cell's data: ``{"rows", "queries"}``. ``load`` builds
the configuration's table from it through the port's own ingest path. The
harness hands the data to the traffic driver and to the reference without
looking inside it, so a table of another shape is another generator.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 18     # rows made a call: a few hundred MB at the widest


def make(config: dict, seed: int, device) -> dict:
    """``rows`` (``[config rows, dim]``) and ``queries`` (``[config
    queries, dim]``) as host float32 arrays, the same for the same seed on
    the same kind of device; ``config["data"]`` holds the sizes above."""
    import torch
    spec, dim = config["data"], config["dim"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lo, hi = spec["centre_low"], spec["centre_high"]
    n_c = spec["centres"]
    if spec["integer"]:
        centres = torch.randint(int(lo), int(hi), (n_c, dim), generator=g,
                                device=device).to(torch.float32)
    else:
        centres = torch.rand((n_c, dim), generator=g, device=device) \
            * (hi - lo) + lo
    out = []
    for n in (config["rows"], config["queries"]):
        arr = np.empty((n, dim), np.float32)
        for s in range(0, n, CHUNK):
            e = min(n, s + CHUNK)
            pick = torch.randint(0, n_c, (e - s,), generator=g, device=device)
            v = centres[pick] + torch.randn((e - s, dim), generator=g,
                                            device=device) * spec["noise_sd"]
            if spec["integer"]:
                v = torch.round(v)
            arr[s:e] = v.clamp_(spec["clip_low"], spec["clip_high"]).cpu().numpy()
        out.append(arr)
    return {"rows": out[0], "queries": out[1]}


def load(ctx, config: dict, data: dict):
    """The configuration's ``ddl`` (its table and vector index), then one
    ``insert_block`` of every row into ``config["table"]``: ids ``0 ..
    N-1`` in row order in ``id``, the vectors in ``emb``."""
    from databend_tpu_torch.expression import Column, DataBlock
    from databend_tpu_torch.types import VectorType
    rows = data["rows"]
    for sql in config["ddl"]:
        ctx.sql(sql)
    ctx.insert_block(config["table"], DataBlock(
        ["id", "emb"],
        [Column.from_numpy(np.arange(len(rows), dtype=np.int64)),
         Column.from_numpy(rows, VectorType(rows.shape[1]))]))
