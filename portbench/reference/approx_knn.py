"""The port's approximate KNN route written from its description, in plain
torch: the specification the CPU tests hold the port to, and the ground
the controls of ``knn_recall`` stand on.

For each chunk of ``query_chunk`` queries:

1. score every row by ``|x|^2 - 2 q.x``, the operands of the product
   rounded to bfloat16 and its products summed in float32 (``|q|^2`` is
   the same for every row of a query and is left out; ``|x|^2`` is the
   float32 sum of the float32 row). The rows are padded to whole tiles of
   ``tile`` rows; a padding row scores +inf;
2. split each tile's rows into ``lanes`` groups: row ``t * tile + g *
   lanes + lane`` is in group ``t * lanes + lane``, so a group holds
   ``tile / lanes`` rows ``lanes`` apart. Keep each group's least score;
3. take the ``shortlist`` groups of least score, equal scores by the lower
   group first, in that order;
4. list each shortlisted group's rows in member order (``g`` ascending),
   group after group, and score each by the float32 sum of its float32
   squared differences from the query; a padding row scores +inf;
5. answer the ``k`` rows of least score, equal scores by their place in
   that list, each with the square root of its score as its distance.

On whole-number rows up to 255 such as SIFT's, every bfloat16 operand,
product and float32 sum of steps 1 and 4 is exact, so the group minima are
the exact ones and the answer holds the rows within the true k-th
distance. The sizes are the configuration's ``approx``: ``tile``,
``lanes``, ``shortlist_groups`` and ``query_chunk``.
"""

from __future__ import annotations

import numpy as np


def _no_tf32():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def first_k(v, k: int):
    """(values, positions) ``[b, k]`` of the ``k`` least of each row of
    ``v``, equal values by the lower position."""
    import torch
    vals, pos = torch.sort(v, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


class Approx:
    """The rows on ``device`` as float32, their bfloat16 copy padded to
    whole tiles, and the float32 norms; ``search`` answers queries by the
    steps of the module doc."""

    def __init__(self, rows: np.ndarray, approx: dict, device,
                 shortlist: int | None = None, lane_shift: int = 0,
                 scan_dtype=None):
        import torch
        _no_tf32()
        self.device = device
        self.tile, self.lanes = approx["tile"], approx["lanes"]
        self.chunk = approx["query_chunk"]
        # the controls' faults: another shortlist, lane or scan precision
        self.shortlist = shortlist or approx["shortlist_groups"]
        self.lane_shift = lane_shift
        self.scan = scan_dtype or torch.bfloat16
        self.x = torch.from_numpy(np.require(rows, np.float32, ["C", "W"])) \
            .to(device)
        self.n = self.x.shape[0]
        self.padded = -(-self.n // self.tile) * self.tile
        # the scan's operand (bfloat16) as float32: each product of two
        # bfloat16 values is exact in float32, and the sums are float32's
        self.xb = self.x.to(self.scan).to(torch.float32)
        self.norms = (self.x * self.x).sum(1)

    def minima(self, q):
        """``[b, groups]`` least score of each group, by group number."""
        import torch
        qb = q.to(self.scan).to(torch.float32)
        s = self.norms[None, :] - 2.0 * (qb @ self.xb.T)
        s = torch.nn.functional.pad(s, (0, self.padded - self.n),
                                    value=float("inf"))
        b, t = q.shape[0], self.padded // self.tile
        return s.view(b, t, self.tile // self.lanes, self.lanes).amin(2) \
            .reshape(b, t * self.lanes)

    def members(self, groups):
        """``[b, shortlist * tile / lanes]`` rows of the shortlisted
        ``groups``, group after group in member order (``lane_shift``
        moves each to the lane that many places on: a fault the controls
        plant)."""
        import torch
        t, lane = groups // self.lanes, groups % self.lanes
        lane = (lane + self.lane_shift) % self.lanes
        g = torch.arange(self.tile // self.lanes, device=groups.device)
        rows = t[:, :, None] * self.tile + g[None, None, :] * self.lanes \
            + lane[:, :, None]
        return rows.reshape(groups.shape[0], -1)

    def search_chunk(self, q, k: int):
        """(ids ``[b, k]`` int64, squared distances ``[b, k]`` float32) of
        one chunk of queries ``q`` (float32 on the device)."""
        import torch
        _, groups = first_k(self.minima(q), self.shortlist)
        rows = self.members(groups)
        diff = self.x[rows.clamp_max(self.n - 1)] - q[:, None, :]
        score = (diff * diff).sum(-1)
        score = score.masked_fill(rows >= self.n, float("inf"))
        d2, pos = first_k(score, k)
        return torch.gather(rows, 1, pos), d2

    def search(self, queries: np.ndarray, k: int):
        """(ids ``[P, k]`` int64, distances ``[P, k]`` float32) of the
        host queries, ``query_chunk`` at a time."""
        import torch
        q_all = torch.from_numpy(np.require(queries, np.float32,
                                            ["C", "W"])).to(self.device)
        ids, ds = [], []
        for s in range(0, len(q_all), self.chunk):
            i, d2 = self.search_chunk(q_all[s:s + self.chunk], k)
            ids.append(i.cpu().numpy())
            ds.append(torch.sqrt(d2).cpu().numpy())
        return np.concatenate(ids), np.concatenate(ds)
