"""Algorithm 1: Adaptive Frame Partitioning (host side).

Port of ``repro/core/partitioning.py``: divide the frame into X x Y zones,
affiliate each RoI with the zone of maximum overlap, shrink each non-empty
zone to the minimum enclosing rectangle of its RoIs, and cut the zones out
as patches.  Patch sizes are rounded up to multiples of ``align``, clamped
to the frame.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Patch:
    """A cut-out region with Tangram metadata (Section III-A)."""
    x0: int
    y0: int
    x1: int
    y1: int
    frame_id: int = 0
    camera_id: int = 0
    t_gen: float = 0.0          # generation time
    slo: float = 1.0            # seconds

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @property
    def area(self) -> int:
        return self.w * self.h

    @property
    def deadline(self) -> float:
        return self.t_gen + self.slo


def partition_host(boxes: np.ndarray, frame_w: int, frame_h: int,
                   zone_x: int, zone_y: int, align: int = 16,
                   frame_id: int = 0, camera_id: int = 0, t_gen: float = 0.0,
                   slo: float = 1.0) -> List[Patch]:
    """Algorithm 1 over (K, 4) xyxy boxes, producing Patch objects."""
    if len(boxes) == 0:
        return []
    zw, zh = frame_w // zone_x, frame_h // zone_y
    zones: dict = {}
    for (x0, y0, x1, y1) in boxes:
        # zone of max overlap
        best, best_area = None, 0
        for zyi in range(zone_y):
            for zxi in range(zone_x):
                ox = max(0, min(x1, (zxi + 1) * zw) - max(x0, zxi * zw))
                oy = max(0, min(y1, (zyi + 1) * zh) - max(y0, zyi * zh))
                if ox * oy > best_area:
                    best_area = ox * oy
                    best = zyi * zone_x + zxi
        if best is None:
            continue
        zones.setdefault(best, []).append((x0, y0, x1, y1))

    patches = []
    for z, bs in sorted(zones.items()):
        x0 = min(b[0] for b in bs)
        y0 = min(b[1] for b in bs)
        x1 = max(b[2] for b in bs)
        y1 = max(b[3] for b in bs)
        w = int(np.ceil((x1 - x0) / align) * align)
        h = int(np.ceil((y1 - y0) / align) * align)
        x1 = min(x0 + w, frame_w)
        x0 = max(x1 - w, 0)
        y1 = min(y0 + h, frame_h)
        y0 = max(y1 - h, 0)
        patches.append(Patch(int(x0), int(y0), int(x1), int(y1),
                             frame_id=frame_id, camera_id=camera_id,
                             t_gen=t_gen, slo=slo))
    return patches
