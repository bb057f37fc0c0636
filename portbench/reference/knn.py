"""Exact nearest rows by l2 in float64, and the comparison of served KNN
answers with them.

The reference works every distance out again from the generated rows and
queries; it reads the port's answers only to judge them. Equal distances
rank by ascending row id, as the JAX reference's ``lax.top_k(-d, k)``
ranks them (a frozen copy of ``chip_smoke.py``'s ``ties_truth``, rewritten
in torch so that it runs on the card in blocks of queries). On whole-number
rows such as SIFT's every float64 distance here is exact.

The numbers compared (``judge``), each against the configuration's limit:

- ``malformed``: queries whose rows are missing, extra, out of range,
  repeated or not finite (and stray rows of no query);
- ``id_mismatch_share``: the share (0 to 1) of the well-formed queries'
  (query, rank) cells whose id is not the reference's;
- ``rank_gap``: the widest gap between the squared distance of a served
  row and the reference's at the same rank, over the reference's k-th;
- ``dist_err``: the widest gap between a served distance and the float32
  of the served row's true distance, over the float32 of the true k-th.
"""

from __future__ import annotations

import numpy as np

BLOCK = 256           # queries a reference block: [256, N] float64 at most


def _no_tf32():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tie_rule_top_k(d, k: int, descending_ties: bool = False):
    """(positions ``[b, k]`` int64, values ``[b, k]``): the ``k`` smallest
    of each row of ``d`` in ascending order, equal values by ascending
    position (by descending position where ``descending_ties``)."""
    import torch
    b = d.shape[0]
    kth = torch.topk(d, k, dim=1, largest=False).values.max(1).values
    r, c = torch.nonzero(d <= kth[:, None], as_tuple=True)   # row-major
    if descending_ties:
        r, c = r.flip(0), c.flip(0)
    v = d[r, c]
    o = torch.sort(v, stable=True).indices
    r, c, v = r[o], c[o], v[o]
    o = torch.sort(r, stable=True).indices
    r, c, v = r[o], c[o], v[o]
    counts = torch.bincount(r, minlength=b)
    take = (torch.cumsum(counts, 0) - counts)[:, None] \
        + torch.arange(k, device=d.device)
    return c[take], v[take]


class Exact:
    """The rows in float64 on ``device``; exact top-k and distances."""

    def __init__(self, rows: np.ndarray, device):
        import torch
        _no_tf32()
        self.device = device
        # float32 across, float64 made on the device
        self.x = torch.from_numpy(np.require(rows, np.float32, ["C", "W"])) \
            .to(device).to(torch.float64)
        self.xx = (self.x * self.x).sum(1)

    def top_k(self, queries: np.ndarray, k: int,
              descending_ties: bool = False):
        """(ids ``[P, k]`` int64, squared distances ``[P, k]`` float64)."""
        import torch
        ids, d2 = [], []
        for s in range(0, len(queries), BLOCK):
            q = torch.from_numpy(np.require(queries[s:s + BLOCK], np.float32,
                                            ["C", "W"])) \
                .to(device=self.device, dtype=torch.float64)
            d = q @ self.x.T
            d.mul_(-2.0).add_((q * q).sum(1)[:, None]).add_(self.xx[None, :])
            i, v = tie_rule_top_k(d, k, descending_ties)
            del d
            ids.append(i.cpu().numpy())
            d2.append(v.cpu().numpy())
        return np.concatenate(ids), np.concatenate(d2)

    def squared(self, queries: np.ndarray, pool: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
        """``[M, k]`` float64 squared distances of ``queries[pool]`` to the
        rows ``ids [M, k]``, by the difference form."""
        import torch
        m, k = ids.shape
        per = max(1, (1 << 27) // (k * self.x.shape[1]))
        out = np.empty((m, k), np.float64)
        for s in range(0, m, per):
            q = torch.from_numpy(queries[pool[s:s + per]]) \
                .to(device=self.device, dtype=torch.float64)
            i = torch.from_numpy(np.ascontiguousarray(ids[s:s + per])) \
                .to(self.device)
            diff = self.x[i] - q[:, None, :]
            out[s:s + per] = (diff * diff).sum(-1).cpu().numpy()
        return out


def well_formed(batch: dict, k: int, n_rows: int):
    """(ok ``[B]`` bool, ids ``[B, k]``, d ``[B, k]``, stray rows) of one
    served batch: query ``j``'s rows are those with ``query_index == j``,
    in served order."""
    b = len(batch["pool"])
    qi = np.asarray(batch["query_index"], np.int64)
    ids = np.asarray(batch["id"], np.int64)
    d = np.asarray(batch["d"], np.float32)
    out_i = np.zeros((b, k), np.int64)
    out_d = np.zeros((b, k), np.float32)
    if len(qi) != len(ids) or len(qi) != len(d):
        return np.zeros(b, bool), out_i, out_d, len(qi)
    inside = (qi >= 0) & (qi < b)
    stray = int((~inside).sum())
    qi, ids, d = qi[inside], ids[inside], d[inside]
    order = np.argsort(qi, kind="stable")
    counts = np.bincount(qi, minlength=b)
    ok = counts == k
    first = np.cumsum(counts) - counts
    take = first[ok][:, None] + np.arange(k)
    out_i[ok] = ids[order][take]
    out_d[ok] = d[order][take]
    srt = np.sort(out_i, 1)
    ok &= (out_i >= 0).all(1) & (out_i < n_rows).all(1) \
        & (np.diff(srt, axis=1) != 0).all(1) & np.isfinite(out_d).all(1)
    return ok, out_i, out_d, stray


def judge(batches: list, data: dict, config: dict, device):
    """(the numbers of the module doc, the count of failed queries: the
    malformed ones) over every batch in ``batches`` (``pool``: the
    positions asked in the data's ``queries``; ``query_index``, ``id``,
    ``d``: the served block's columns), against the data's ``rows`` and
    the configuration's ``k``."""
    rows, queries, k = data["rows"], data["queries"], config["k"]
    ref = Exact(rows, device)
    ref_ids, ref_d2 = ref.top_k(queries, k)
    kth = np.maximum(ref_d2[:, -1], 1e-300)
    pools, ids, ds, bad = [], [], [], 0
    for b in batches:
        ok, i, d, stray = well_formed(b, k, len(rows))
        bad += int((~ok).sum()) + stray
        pools.append(np.asarray(b["pool"])[ok])
        ids.append(i[ok])
        ds.append(d[ok])
    pool = np.concatenate(pools)
    ids = np.concatenate(ids)
    d = np.concatenate(ds)
    out = {"malformed": bad, "answered": int(len(pool))}
    if not len(pool):
        out.update(id_mismatch_share=0.0, rank_gap=float("inf"),
                   dist_err=float("inf"))
        return out, bad
    served = ref.squared(queries, pool, ids)
    out["id_mismatch_share"] = float((ids != ref_ids[pool]).mean())
    out["rank_gap"] = float(
        (np.abs(served - ref_d2[pool]) / kth[pool][:, None]).max())
    true_d = np.sqrt(served).astype(np.float32)
    kth_d = np.sqrt(kth).astype(np.float32)
    out["dist_err"] = float(
        (np.abs(d.astype(np.float64) - true_d) / kth_d[pool][:, None]).max())
    del ref
    return out, bad
