"""Device mesh of the port: construction only, no mesh is handed out yet.

The reference builds a ``(dp, shard)`` ``jax.sharding.Mesh`` over
``jax.devices()`` and runs its exchanges as XLA collectives. The port's
exchanges are not written (ROADMAP.md item 11b), so a mesh here is a plain
``[dp, shard]`` grid of torch devices that nothing consumes, and
:func:`get_default_mesh` returns None whatever the number of cards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import backend

SHARD_AXIS = "shard"
DP_AXIS = "dp"


class Mesh(NamedTuple):
    """``devices``: object array ``[dp, shard]`` of ``torch.device``."""
    devices: np.ndarray
    axis_names: Tuple[str, str]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(dp, shard)`` mesh over ``n_devices`` (default: all of
    ``backend.devices()``).

    ``dp`` splits the query batch; the remaining factor shards the corpus.
    """
    if devices is None:
        devices = backend.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, n_devices // dp), (DP_AXIS, SHARD_AXIS))


def get_default_mesh() -> Optional[Mesh]:
    """Process-wide mesh for the distributed operators: None under two
    devices, as in the reference, and None with two or more cards as well
    until the exchanges are ported (ROADMAP.md item 11b). The port answers
    on one device; every caller takes None as "run the host operator"."""
    return None
