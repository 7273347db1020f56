"""Patch-stitching Solver (Algorithm 2, lines 24-39).

Port of ``repro/core/stitching.py`` (plain Python and numpy).  Guillotine
2-D packing with the paper's placement rule: among free rectangles that fit
the patch, choose the one minimizing ``min(w_c - w_i, h_c - h_i)``
(best-short-side-fit), place the patch at the bottom-left corner, and split
the residual space into two non-overlapping rectangles along the *shorter
axis* of the free rectangle.  When no free rectangle fits, a new canvas is
opened.

Because the solver consumes the queue in order and never moves a placed
patch, packing ``Q + [p]`` equals packing ``Q`` and then placing ``p`` into
the resulting free-rectangle state: :class:`PackState` appends each arrival
incrementally, and ``stitch`` and ``PackState.append`` share one placement
routine, so the two agree by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partitioning import Patch


@dataclasses.dataclass(frozen=True)
class FreeRect:
    x: int
    y: int
    w: int
    h: int


@dataclasses.dataclass(frozen=True)
class Placement:
    patch_idx: int          # index into the stitched queue
    canvas_idx: int
    x: int
    y: int
    w: int
    h: int


@dataclasses.dataclass
class Canvas:
    m: int                  # height (M)
    n: int                  # width  (N)
    free: List[FreeRect] = dataclasses.field(default_factory=list)
    placements: List[Placement] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.free and not self.placements:
            self.free = [FreeRect(0, 0, self.n, self.m)]

    @property
    def used_area(self) -> int:
        return sum(p.w * p.h for p in self.placements)

    @property
    def efficiency(self) -> float:
        return self.used_area / (self.m * self.n)


def _choose(free: Sequence[FreeRect], w: int, h: int) -> Optional[int]:
    """Best-short-side-fit: argmin over fitting rects of min(dw, dh)."""
    best, best_key = None, None
    for i, c in enumerate(free):
        if c.w >= w and c.h >= h:
            key = (min(c.w - w, c.h - h), c.w * c.h)
            if best_key is None or key < best_key:
                best, best_key = i, key
    return best


def _split(c: FreeRect, w: int, h: int) -> List[FreeRect]:
    """Place (w, h) at the bottom-left of c; split residual on the rect's
    shorter axis (SAS rule).  Returns 0-2 non-empty free rects."""
    out = []
    if c.w <= c.h:
        # shorter axis horizontal: right strip of patch height, then the
        # full-width band above the patch row
        if c.w - w > 0:
            out.append(FreeRect(c.x + w, c.y, c.w - w, h))
        if c.h - h > 0:
            out.append(FreeRect(c.x, c.y + h, c.w, c.h - h))
    else:
        # shorter axis vertical: full-height strip right of the patch, then
        # the patch-width strip above it
        if c.w - w > 0:
            out.append(FreeRect(c.x + w, c.y, c.w - w, c.h))
        if c.h - h > 0:
            out.append(FreeRect(c.x, c.y + h, w, c.h - h))
    return out


class PackState:
    """Mutable guillotine packing state with O(1)-per-patch appends.

    After appending patches p_0..p_k in order the state is identical to
    ``stitch([p_0..p_k])``.
    """

    def __init__(self, m: int, n: int):
        self.m, self.n = m, n
        self.canvases: List[Canvas] = []
        self.count = 0              # patches packed (next patch_idx)

    def append(self, patch: Patch) -> None:
        """Place one patch (queue index ``self.count``) into the state."""
        i = self.count
        p = patch
        if p.w > self.n or p.h > self.m:
            raise ValueError(
                f"patch {i} ({p.w}x{p.h}) exceeds canvas ({self.n}x{self.m})")
        for ci, canvas in enumerate(self.canvases):
            j = _choose(canvas.free, p.w, p.h)
            if j is not None:
                c = canvas.free.pop(j)
                canvas.placements.append(
                    Placement(i, ci, c.x, c.y, p.w, p.h))
                canvas.free.extend(_split(c, p.w, p.h))
                self.count = i + 1
                return
        canvas = Canvas(self.m, self.n)
        c = canvas.free.pop(0)
        canvas.placements.append(
            Placement(i, len(self.canvases), c.x, c.y, p.w, p.h))
        canvas.free.extend(_split(c, p.w, p.h))
        self.canvases.append(canvas)
        self.count = i + 1

    def fits(self, w: int, h: int) -> bool:
        """Read-only probe: would a (w, h) patch fit an open canvas?"""
        return any(_choose(c.free, w, h) is not None for c in self.canvases)

    def reset(self, patches: Sequence[Patch] = ()) -> None:
        """Full repack: rebuild the state from an explicit queue."""
        self.canvases = []
        self.count = 0
        for p in patches:
            self.append(p)


def stitch(patches: Sequence[Patch], m: int, n: int) -> List[Canvas]:
    """Pack patches (in queue order) onto canvases of size m x n.
    Patches larger than the canvas raise ValueError."""
    state = PackState(m, n)
    for p in patches:
        state.append(p)
    return state.canvases


# eq=False: the generated __eq__ would elementwise-compare the records
# ndarray and raise in truth contexts
@dataclasses.dataclass(frozen=True, eq=False)
class BatchPlan:
    """Device-ready layout for stitching one multi-canvas batch: one kernel
    launch stitches all ``num_canvases`` canvases, and the same records
    drive the inverse unstitch gather."""
    canvas_m: int
    canvas_n: int
    num_canvases: int
    num_patches: int
    slots_per_canvas: int            # K: max placements on any canvas
    hmax: int                        # patch slot height (pow2-bucketed)
    wmax: int                        # patch slot width  (pow2-bucketed)
    records: np.ndarray              # (B, K, 6) int32: valid, slot, x, y, w, h
    slot_capacity: int = 0           # pow2-bucketed slot count >= num_patches

    def __post_init__(self):
        # derive (or repair) the capacity so manually built plans can't
        # violate the >= num_patches invariant pack_plan_host relies on
        if self.slot_capacity < max(self.num_patches, 1):
            object.__setattr__(self, "slot_capacity",
                               _bucket_pow2(self.num_patches, 1 << 30))

    @property
    def canvas_batch_shape(self) -> Tuple[int, int, int]:
        return (self.num_canvases, self.canvas_m, self.canvas_n)

    def placements(self):
        """Yield (canvas_idx, patch_idx, x, y, w, h) for valid records."""
        for bi in range(self.records.shape[0]):
            for rec in self.records[bi]:
                if rec[0] > 0:
                    yield (bi, int(rec[1]), int(rec[2]), int(rec[3]),
                           int(rec[4]), int(rec[5]))


def _bucket_pow2(x: int, cap: int) -> int:
    """Round x up to the next power of two, clamped to cap (min 1)."""
    x = max(x, 1)
    return min(1 << (x - 1).bit_length(), cap)


def build_batch_plan(patches: Sequence[Patch], canvases: Sequence[Canvas],
                     m: int, n: int, *, min_slots: int = 1) -> BatchPlan:
    """Flatten a packing (list of canvases) into one batched plan.

    Slot extents, the slot count and K are bucketed to powers of two so
    shapes repeat across invocations; padding records are all zero
    (``valid=0, slot=0``).  An empty packing yields a (0, K, 6) plan.
    """
    hmax = _bucket_pow2(max((p.h for p in patches), default=1), m)
    wmax = _bucket_pow2(max((p.w for p in patches), default=1), n)
    k = _bucket_pow2(
        max(max((len(c.placements) for c in canvases), default=0),
            min_slots), 1 << 30)
    b = len(canvases)
    records = np.zeros((b, k, 6), np.int32)
    for bi, canvas in enumerate(canvases):
        for ki, pl_ in enumerate(canvas.placements):
            records[bi, ki] = (1, pl_.patch_idx, pl_.x, pl_.y, pl_.w, pl_.h)
    return BatchPlan(canvas_m=m, canvas_n=n, num_canvases=b,
                     num_patches=len(patches), slots_per_canvas=k,
                     hmax=hmax, wmax=wmax, records=records)


def total_efficiency(canvases: Sequence[Canvas]) -> float:
    if not canvases:
        return 0.0
    used = sum(c.used_area for c in canvases)
    return used / sum(c.m * c.n for c in canvases)


def validate(canvases: Sequence[Canvas]) -> None:
    """Invariants: in-bounds and non-overlapping placements."""
    for canvas in canvases:
        for p in canvas.placements:
            if not (0 <= p.x and p.x + p.w <= canvas.n
                    and 0 <= p.y and p.y + p.h <= canvas.m):
                raise AssertionError(f"placement out of canvas: {p}")
        ps = canvas.placements
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                a, b = ps[i], ps[j]
                sep = (a.x + a.w <= b.x or b.x + b.w <= a.x or
                       a.y + a.h <= b.y or b.y + b.h <= a.y)
                if not sep:
                    raise AssertionError(f"overlapping placements: {a}, {b}")
