"""The controls of the ``knn_recall`` reference: the plain approximate route
(``approx_knn``) put in the port's place with a fault a sound check has to
refuse. The benchmark's own runs never run them; ``portbench/control.py``
reads them on the card through the harness's own run and verdict. Each is
built from the cell's data and configuration as ``CONTROLS[name](data,
config, device)`` and serves ``execute_batch_block(params, exact)`` as the
prepared statement does: one block with ``query_index``, ``id`` and ``d``.

- ``short_shortlist``: the route with a shortlist of ``k / 2`` groups, so
  that a query whose true rows lie in more groups loses some;
- ``wrong_member``: the shortlist's expansion one lane off, so the rows
  re-ranked are another group's;
- ``stale_batch``: each batch answered with the previous batch's block
  (the first with its own);
- ``fp8_scan``: the route with the scan's operands rounded to float8
  (e4m3), the nearest precision below the stated bfloat16 that the H100's
  tensor cores take, its products still summed in float32.

The re-rank has no control of precision: on whole-number rows up to 255 a
bfloat16 re-rank (bfloat16 operands, float32 sums) is exact, as the
route's bfloat16 scan is, so the nearest precision below the stated
float32 cannot be told from it on this data.
"""

from __future__ import annotations

from .approx_knn import Approx
from .knn_control import Answer, _queries


class _Route:
    """The route of ``approx_knn`` on the cell's rows."""

    def __init__(self, data: dict, config: dict, device, **fault):
        self.k = config["k"]
        self.route = Approx(data["rows"], config["approx"], device, **fault)

    def execute_batch_block(self, params, exact: bool = False) -> Answer:
        ids, d = self.route.search(_queries(params), self.k)
        return Answer(ids, d)


class ShortShortlist(_Route):
    def __init__(self, data: dict, config: dict, device):
        super().__init__(data, config, device,
                         shortlist=max(1, config["k"] // 2))


class WrongMember(_Route):
    def __init__(self, data: dict, config: dict, device):
        super().__init__(data, config, device, lane_shift=1)


class StaleBatch(_Route):
    def __init__(self, data: dict, config: dict, device):
        super().__init__(data, config, device)
        self.last = None

    def execute_batch_block(self, params, exact: bool = False) -> Answer:
        now = super().execute_batch_block(params, exact)
        out, self.last = self.last or now, now
        return out


class Fp8Scan(_Route):
    def __init__(self, data: dict, config: dict, device):
        import torch
        super().__init__(data, config, device,
                         scan_dtype=torch.float8_e4m3fn)


CONTROLS = {"short_shortlist": ShortShortlist, "wrong_member": WrongMember,
            "stale_batch": StaleBatch, "fp8_scan": Fp8Scan}
