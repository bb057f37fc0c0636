"""The controls of the ``knn`` reference: the reference put in the port's
place in a way that a sound check has to refuse. The benchmark's own runs
never run them; ``portbench/control.py`` reads them on the card through the
harness's own run and verdict, and ``portbench/tests/test_pb_controls.py``
keeps them at a size a test run holds. Each is built from the cell's data
and configuration as ``CONTROLS[name](data, config, device)``.

- ``TF32Product``: the nearest precision below the configuration's float32,
  the step that would tempt a later change: l2 by the norm expansion with
  the product in TF32 (on the card the tensor cores' TF32, on the CPU its
  operands rounded to TF32's 10 mantissa bits), the tie rule, and the
  distances from the same TF32 expansion.
- ``TieOrder``: the float64 reference with equal distances ranked by
  descending row id, which breaks the configuration's tie rule.

Each serves ``execute_batch_block(params, exact=True)`` as the prepared
statement does: one block with ``query_index``, ``id`` and ``d`` columns.
"""

from __future__ import annotations

import numpy as np

from .knn import BLOCK, Exact, tie_rule_top_k


class _Column:
    def __init__(self, values: np.ndarray):
        self.values = values

    def numpy(self) -> np.ndarray:
        return self.values


class Answer:
    """A served block: ``answer.block.column(name).numpy()``."""

    def __init__(self, ids: np.ndarray, d: np.ndarray):
        b, k = ids.shape
        self.block = self
        self._cols = {"query_index": np.repeat(np.arange(b), k),
                      "id": ids.reshape(-1), "d": d.reshape(-1)}

    def column(self, name: str) -> _Column:
        return _Column(self._cols[name])


def _queries(params) -> np.ndarray:
    return np.stack([np.asarray(p[0], np.float32) for p in params])


def round_to_tf32(t):
    """``t`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits, ties to even)."""
    import torch
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class TF32Product:
    def __init__(self, data: dict, config: dict, device):
        import torch
        self.k, self.device = config["k"], device
        self.x = torch.from_numpy(np.require(data["rows"], np.float32,
                                             ["C", "W"])).to(device)
        self.xx = (self.x * self.x).sum(1)

    def _product(self, q):
        import torch
        if q.device.type != "cuda":
            return round_to_tf32(q) @ round_to_tf32(self.x).T
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return q @ self.x.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was

    def execute_batch_block(self, params, exact: bool = True) -> Answer:
        import torch
        q_all = torch.from_numpy(_queries(params)).to(self.device)
        ids, ds = [], []
        for s in range(0, len(q_all), BLOCK):
            q = q_all[s:s + BLOCK]
            d2 = torch.clamp_min((q * q).sum(1)[:, None] - 2.0 * self._product(q)
                                 + self.xx[None, :], 0.0)
            i, v = tie_rule_top_k(torch.sqrt(d2), self.k)
            ids.append(i.cpu().numpy())
            ds.append(v.cpu().numpy())
        return Answer(np.concatenate(ids), np.concatenate(ds))


class TieOrder:
    def __init__(self, data: dict, config: dict, device):
        self.k = config["k"]
        self.ref = Exact(data["rows"], device)

    def execute_batch_block(self, params, exact: bool = True) -> Answer:
        ids, d2 = self.ref.top_k(_queries(params), self.k,
                                 descending_ties=True)
        return Answer(ids, np.sqrt(d2).astype(np.float32))


CONTROLS = {"tf32": TF32Product, "ties": TieOrder}
