"""Transmission byte model + bandwidth-shaped patch arrival.

Port of the patch half of ``repro/data/video.py`` (plain Python): a
compressed patch is ``header + area * BPP_FG`` bytes (the reference
calibrates its bits-per-pixel model so a 3840x2160 frame is ~1.0 MB).

:class:`Uplink` is one camera's FIFO link shaping patches as they are
produced; :func:`shape_arrivals` shapes a whole per-camera list through it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.partitioning import Patch

BPP_FG = 0.25         # bytes/pixel, high-quality RoI crops
HEADER_BYTES = 256


def patch_bytes(p: Patch) -> float:
    return HEADER_BYTES + p.area * BPP_FG


@dataclasses.dataclass
class Arrival:
    t_arrive: float
    patch: Patch
    n_bytes: float


class Uplink:
    """One camera's FIFO uplink: arrival time = max(t_gen, link free) +
    bytes / bandwidth, patches serialised in send order, with running
    byte/transmission totals."""

    def __init__(self, bandwidth_bps: float):
        if bandwidth_bps <= 0:
            raise ValueError(f"bandwidth must be positive, got "
                             f"{bandwidth_bps}")
        self.byte_rate = bandwidth_bps / 8.0
        self.link_free = 0.0
        self.bytes_sent = 0.0
        self.transmission_seconds = 0.0
        self.n_sent = 0

    def send(self, p: Patch) -> Arrival:
        b = patch_bytes(p)
        start = max(p.t_gen, self.link_free)
        t_arr = start + b / self.byte_rate
        self.link_free = t_arr
        self.bytes_sent += b
        self.transmission_seconds += t_arr - p.t_gen
        self.n_sent += 1
        return Arrival(t_arr, p, b)


def shape_arrivals(patches: Sequence[Patch], bandwidth_bps: float
                   ) -> List[Arrival]:
    """FIFO uplink over one camera's patches (in generation order)."""
    link = Uplink(bandwidth_bps)
    return [link.send(p) for p in patches]


def merge_arrivals(per_camera: Sequence[List[Arrival]]) -> List[Arrival]:
    out = [a for cam in per_camera for a in cam]
    out.sort(key=lambda a: a.t_arrive)
    return out
