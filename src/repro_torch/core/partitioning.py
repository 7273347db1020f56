"""Algorithm 1: Adaptive Frame Partitioning.

Port of ``repro/core/partitioning.py``: divide the frame into X x Y zones,
affiliate each RoI with the zone of maximum overlap, shrink each non-empty
zone to the minimum enclosing rectangle of its RoIs, and cut the zones out
as patches.  Patch sizes are rounded up to multiples of ``align``, clamped
to the frame.  Two implementations with the same semantics:

* ``partition``      -- on tensors (any device), static X*Y patch slots
  and a validity mask;
* ``partition_host`` -- plain numpy, Patch objects for the scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


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


def align_up(lo, hi, limit: int, align: int = 16):
    """Grow ``[lo, hi)`` to a multiple of ``align`` and slide it back
    inside ``[0, limit)``; numbers or numpy arrays (Algorithm 1's
    size alignment)."""
    size = -(-(hi - lo) // align) * align      # ceil, for ints and floats
    hi = np.minimum(lo + size, limit)
    lo = np.maximum(hi - size, 0)
    return lo, hi


def _overlap_1d(a0, a1, b0, b1):
    return (torch.minimum(a1, b1) - torch.maximum(a0, b0)).clamp_min(0)


def partition(boxes: torch.Tensor, valid: torch.Tensor, frame_w: int,
              frame_h: int, zone_x: int, zone_y: int, align: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes: (K, 4) int32 xyxy RoIs; valid: (K,) bool.  Returns (patches
    (X*Y, 4) int32 xyxy, zeros where a zone holds no RoI; patch_valid
    (X*Y,) bool), on the boxes' device.  A box that overlaps several zones
    equally goes to the first (``argmax``); one that overlaps none is
    dropped."""
    dev = boxes.device
    n_zones = zone_x * zone_y
    zw, zh = frame_w // zone_x, frame_h // zone_y
    zi = torch.arange(n_zones, dtype=torch.int32, device=dev)
    zx0 = (zi % zone_x) * zw
    zy0 = (zi // zone_x) * zh
    zx1, zy1 = zx0 + zw, zy0 + zh

    b = boxes.to(torch.int32)
    bx0, by0, bx1, by1 = (b[:, i] for i in range(4))
    ox = _overlap_1d(bx0[:, None], bx1[:, None], zx0[None, :], zx1[None, :])
    oy = _overlap_1d(by0[:, None], by1[:, None], zy0[None, :], zy1[None, :])
    overlap = ox.to(torch.int64) * oy                    # (K, Z)
    zone_of = overlap.argmax(dim=1)                      # (K,)
    use = valid.to(torch.bool) & (overlap.amax(dim=1) > 0)
    member = (torch.nn.functional.one_hot(zone_of, n_zones).to(torch.bool)
              & use[:, None])                            # (K, Z)
    big = 1 << 30

    def pick(col, fill, reduce):
        if col.shape[0] == 0:       # amin / amax take no empty axis
            return torch.full((n_zones,), fill, dtype=torch.int32,
                              device=dev)
        return reduce(torch.where(member, col[:, None], fill), dim=0)

    px0 = pick(bx0, big, torch.amin)
    py0 = pick(by0, big, torch.amin)
    px1 = pick(bx1, -big, torch.amax)
    py1 = pick(by1, -big, torch.amax)
    patch_valid = member.sum(dim=0) > 0

    def aligned(lo, hi, limit):
        size = -(-(hi - lo) // align) * align
        hi = torch.clamp(lo + size, max=limit)
        return torch.clamp(hi - size, min=0), hi

    px0, px1 = aligned(px0, px1, frame_w)
    py0, py1 = aligned(py0, py1, frame_h)
    patches = torch.stack([px0, py0, px1, py1], dim=-1) * patch_valid[:, None]
    return patches.to(torch.int32), patch_valid


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
        x0, x1 = align_up(min(b[0] for b in bs), max(b[2] for b in bs),
                          frame_w, align)
        y0, y1 = align_up(min(b[1] for b in bs), max(b[3] for b in bs),
                          frame_h, align)
        patches.append(Patch(int(x0), int(y0), int(x1), int(y1),
                             frame_id=frame_id, camera_id=camera_id,
                             t_gen=t_gen, slo=slo))
    return patches


def patch_pixels(frame: np.ndarray, p: Patch) -> np.ndarray:
    return frame[p.y0:p.y1, p.x0:p.x1]


def coverage(patches: List[Patch], boxes: np.ndarray) -> float:
    """Fraction of ground-truth boxes fully covered by some patch
    (the Table III accuracy proxy: a covered object is detectable)."""
    if len(boxes) == 0:
        return 1.0
    covered = 0
    for (x0, y0, x1, y1) in boxes:
        for p in patches:
            if p.x0 <= x0 and p.y0 <= y0 and p.x1 >= x1 and p.y1 >= y1:
                covered += 1
                break
    return covered / len(boxes)
