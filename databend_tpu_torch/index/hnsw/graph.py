"""HNSW graph container + serialization.

TPU-native re-design of the reference's HNSW storage
(reference: src/query/storages/common/index/src/hnsw_index/{graph_layers.rs,
graph_links.rs}). The reference bitpacks link lists for CPU cache walks;
on TPU the graph IS the layout the kernels gather from: dense padded
``[n, m]`` int32 neighbor arrays per level, -1 padding — one
``jnp.take`` per beam expansion, no decode step.

Level semantics match the reference (hnsw.rs:53-59): level 0 keeps
``m0 = 2*m`` links, upper levels ``m``; point levels are geometric with
factor ``1/ln(m)`` (graph_layers_builder.rs:242-249).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class HnswGraph:
    """links[0] is [n, m0]; links[l>0] are [n_l, m] over ``level_ids[l]``
    (global point ids of that level's members, sorted ascending). All link
    entries are GLOBAL point ids, -1 = padding."""

    metric: str  # cosine | l2 | ip | l1 (cosine vectors are pre-normalized)
    m: int
    ef_construct: int
    entry_points: np.ndarray  # [e] global ids, highest level first
    links: List[np.ndarray] = field(default_factory=list)
    level_ids: List[Optional[np.ndarray]] = field(default_factory=list)  # None for level 0

    @property
    def num_points(self) -> int:
        return self.links[0].shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.links)

    @property
    def m0(self) -> int:
        return self.links[0].shape[1]

    def nbytes(self) -> int:
        return sum(l.nbytes for l in self.links) + sum(
            i.nbytes for i in self.level_ids if i is not None)

    # ------------------------------------------------------------- serialize
    def to_bytes(self, format: str = "plain") -> bytes:
        """``plain`` = dense padded int32 per level (the HBM layout,
        zero decode); ``compressed`` = per-level bitpacked sorted-
        neighbor deltas — the analog of the reference's
        ``GraphLinksFormat::Compressed`` (graph_links/serializer.rs:38,
        bitpacking_links.rs). Both decode back to the same dense padded
        arrays the TPU kernels gather from."""
        if format not in ("plain", "compressed"):
            raise ValueError(f"unknown graph links format {format!r}")
        buf = io.BytesIO()
        payload = {
            "meta": np.array([self.m, self.ef_construct, self.num_levels],
                             dtype=np.int64),
            "metric": np.frombuffer(self.metric.encode(), dtype=np.uint8),
            "entry_points": self.entry_points.astype(np.int32),
        }
        for l, arr in enumerate(self.links):
            if format == "compressed":
                counts, bits, packed = _pack_links(arr)
                payload[f"clinks_{l}_counts"] = counts
                payload[f"clinks_{l}_meta"] = np.array(
                    [bits, arr.shape[0], arr.shape[1]], np.int64)
                payload[f"clinks_{l}_packed"] = packed
            else:
                payload[f"links_{l}"] = arr.astype(np.int32)
        for l, ids in enumerate(self.level_ids):
            if ids is not None:
                payload[f"ids_{l}"] = ids.astype(np.int32)
        np.savez_compressed(buf, **payload)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "HnswGraph":
        z = np.load(io.BytesIO(data))
        m, ef_construct, num_levels = z["meta"].tolist()
        metric = z["metric"].tobytes().decode()
        links = []
        for l in range(num_levels):
            if f"links_{l}" in z:
                links.append(z[f"links_{l}"])
            else:
                bits, n, width = z[f"clinks_{l}_meta"].tolist()
                links.append(_unpack_links(
                    z[f"clinks_{l}_counts"], int(bits),
                    z[f"clinks_{l}_packed"], int(n), int(width)))
        level_ids: List[Optional[np.ndarray]] = [None] * num_levels
        for l in range(1, num_levels):
            if f"ids_{l}" in z:
                level_ids[l] = z[f"ids_{l}"]
        return HnswGraph(metric, int(m), int(ef_construct),
                         z["entry_points"], links, level_ids)

    def save(self, path: str, format: str = "plain") -> int:
        from ...storage.operator import OPERATOR
        data = self.to_bytes(format)
        OPERATOR.write_bytes(path, data)
        return len(data)

    @staticmethod
    def load(path: str) -> "HnswGraph":
        from ...storage.operator import OPERATOR
        return HnswGraph.from_bytes(OPERATOR.read_bytes(path))


# --------------------------------------------------- bitpacked link lists
# Vectorized bitpacking of per-row sorted neighbor deltas (the reference
# packs per-point link lists the same way, common/bitpacking.rs +
# bitpacking_links.rs; decode always rebuilds the dense padded arrays the
# TPU gather kernels want, so compression is a storage concern only).

def _pack_links(arr: np.ndarray):
    """[n, w] int32 with -1 padding -> (counts u16, bits, packed u8)."""
    a = arr.astype(np.int64)
    big = np.where(a < 0, np.iinfo(np.int64).max, a)
    srt = np.sort(big, axis=1)
    counts = (a >= 0).sum(axis=1).astype(np.uint16)
    w = arr.shape[1]
    col = np.arange(w)[None, :]
    valid = col < counts[:, None].astype(np.int64)
    prev = np.concatenate(
        [np.full((srt.shape[0], 1), -1, np.int64), srt[:, :-1]], axis=1)
    deltas = np.where(valid, srt - prev, 0)
    flat = deltas[valid]
    if flat.size == 0:
        return counts, 1, np.zeros(0, np.uint8)
    bits = max(1, int(flat.max()).bit_length())
    # value -> [total, bits] little-endian bit matrix -> packbits
    bitmat = ((flat[:, None] >> np.arange(bits)[None, :]) & 1
              ).astype(np.uint8)
    return counts, bits, np.packbits(bitmat.reshape(-1))


def _unpack_links(counts: np.ndarray, bits: int, packed: np.ndarray,
                  n: int, width: int) -> np.ndarray:
    out = np.full((n, width), -1, np.int32)
    total = int(counts.astype(np.int64).sum())
    if total == 0:
        return out
    bitvec = np.unpackbits(packed)[: total * bits]
    vals = (bitvec.reshape(total, bits).astype(np.int64)
            << np.arange(bits)[None, :]).sum(axis=1)
    # un-delta within each row: neighbor_i = (running sum of the row's
    # deltas through i) - 1, because the first delta was taken vs -1
    row_of = np.repeat(np.arange(n), counts.astype(np.int64))
    csum = np.cumsum(vals)
    starts = np.concatenate(
        [[0], np.cumsum(counts.astype(np.int64))])[:-1]
    nonzero = counts.astype(np.int64) > 0
    prior = np.zeros(n, np.int64)  # cumsum before each row's first delta
    prior[nonzero] = csum[starts[nonzero]] - vals[starts[nonzero]]
    neighbors = csum - prior[row_of] - 1
    col = np.arange(total) - starts[row_of]
    out[row_of, col] = neighbors.astype(np.int32)
    return out
