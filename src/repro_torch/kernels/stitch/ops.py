"""Public entries for canvas stitch/unstitch, the fused stitch->embed and
decode->gather, host-side packing (padded, or compact with the slots laid
out on the device) and routing.

Port of ``repro/kernels/stitch/ops.py``.  ``impl`` picks
the implementation: ``"cuda"`` launches the hand-written kernel,
``"torch"`` runs the plain version.  The default follows the tensor's
device, so a CUDA tensor always reaches the kernel and a CPU tensor (the
tests) the plain version; ``impl="cuda"`` on a CPU tensor raises, and so
does a kernel on inputs that require grad (``launches.refuse_grad``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import BatchPlan
from repro_torch.kernels.launches import refuse_grad
from repro_torch.kernels.stitch.fused_embed import (k4_tile,
                                                    stitch_embed_cuda,
                                                    unstitch_decode_cuda)
from repro_torch.kernels.stitch.ref import (stitch_embed_reference,
                                            stitch_reference,
                                            unstitch_decode_reference,
                                            unstitch_reference)
from repro_torch.kernels.stitch.stitch import stitch_cuda, unstitch_cuda

IMPLS = ("cuda", "torch")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``None`` -> by device; otherwise a checked name."""
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown stitch impl {impl!r}; choose from "
                         f"{list(IMPLS)}")
    return impl


def stitch_canvases(patch_pixels: torch.Tensor, records: torch.Tensor,
                    m: int, n: int, impl: Optional[str] = None
                    ) -> torch.Tensor:
    """Assemble a batch of canvases from padded patch slots."""
    if resolve_impl(impl, patch_pixels) == "cuda":
        refuse_grad("stitch", patch_pixels)
        return stitch_cuda(patch_pixels, records, m, n)
    return stitch_reference(patch_pixels, records, m, n)


def unstitch_patches(canvases: torch.Tensor, records: torch.Tensor,
                     num_patches: int, hmax: int, wmax: int,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`stitch_canvases`: canvases -> padded patch slots."""
    if resolve_impl(impl, canvases) == "cuda":
        refuse_grad("unstitch", canvases)
        return unstitch_cuda(canvases, records, num_patches, hmax, wmax)
    return unstitch_reference(canvases, records, num_patches, hmax, wmax)


def stitch_embed(patch_pixels: torch.Tensor, records: torch.Tensor,
                 kernel: torch.Tensor, bias: torch.Tensor, m: int, n: int,
                 patch: int, impl: Optional[str] = None,
                 tile=None) -> torch.Tensor:
    """Fused stitch -> patchify -> patch embed: slots to (B, seq, d)
    tokens without a canvas batch in device memory.  ``tile``: the bf16
    kernel's block tile (``fused_embed.K4_TILES``; ``None`` is the
    default; another raises on any device); the plain version has no
    tile."""
    k4_tile(tile)
    if resolve_impl(impl, patch_pixels) == "cuda":
        refuse_grad("stitch_embed", patch_pixels, kernel, bias)
        return stitch_embed_cuda(patch_pixels, records, kernel, bias, m, n,
                                 patch, tile=tile)
    return stitch_embed_reference(patch_pixels, records, kernel, bias, m, n,
                                  patch)


def unstitch_decode(raw: torch.Tensor, records: torch.Tensor, patch: int,
                    num_patches: int, impl: Optional[str] = None
                    ) -> torch.Tensor:
    """Fused head decode + placement gather: raw (B, s, s, 5) head outputs
    to per-slot (num_patches, s, s, 5) decoded grids."""
    if resolve_impl(impl, raw) == "cuda":
        refuse_grad("unstitch_decode", raw)
        return unstitch_decode_cuda(raw, records, patch, num_patches)
    return unstitch_decode_reference(raw, records, patch, num_patches)


def check_records(plan: BatchPlan) -> None:
    """Host-side contract of both kernels, checked on the plan's numpy
    records before launch: valid placements lie inside the canvas, fit
    their slot, and index a slot below ``slot_capacity``."""
    r = plan.records[plan.records[..., 0] > 0]          # (valid, 6)
    slot, x, y, w, h = (r[:, i] for i in range(1, 6))
    bad = ((slot < 0) | (slot >= plan.slot_capacity) | (w <= 0) | (h <= 0)
           | (w > plan.wmax) | (h > plan.hmax) | (x < 0) | (y < 0)
           | (x + w > plan.canvas_n) | (y + h > plan.canvas_m))
    if bad.any():
        raise ValueError(f"plan has {int(bad.sum())} placement(s) outside "
                         f"the kernels' contract: {r[bad][:4].tolist()}")


def pack_plan_host(frame_pixels: Sequence[np.ndarray],
                   plan: BatchPlan) -> np.ndarray:
    """Host prep: copy patch crops into the plan's padded slot array.

    frame_pixels[i] is the (h, w, C) crop for queue patch i.  Returns
    (slot_capacity, hmax, wmax, C) float32, zero-padded.
    """
    c = frame_pixels[0].shape[-1] if frame_pixels else 3
    slots = np.zeros((plan.slot_capacity, plan.hmax, plan.wmax, c),
                     np.float32)
    for i, px in enumerate(frame_pixels):
        h, w = px.shape[:2]
        if h > plan.hmax or w > plan.wmax:
            raise ValueError(f"crop {i} ({h}x{w}) exceeds the plan's slot "
                             f"({plan.hmax}x{plan.wmax})")
        slots[i, :h, :w] = px
    return slots


class CompactCrops(NamedTuple):
    """:func:`pack_plan_compact`'s result: crop i is ``flat[offsets[i]:
    offsets[i] + h * w * channels]``, row-major (h, w, C), ``(h, w) =
    hw[i]``."""
    flat: np.ndarray            # float32, the crops back to back
    offsets: np.ndarray         # (P,) int64
    hw: np.ndarray              # (P, 2) int64
    channels: int

    def crop(self, i: int) -> np.ndarray:
        """Crop ``i`` as an (h, w, C) view of ``flat``."""
        h, w = (int(v) for v in self.hw[i])
        o = int(self.offsets[i])
        return self.flat[o:o + h * w * self.channels].reshape(
            h, w, self.channels)


def pack_plan_compact(frame_pixels: Sequence[np.ndarray], plan: BatchPlan,
                      out: Optional[np.ndarray] = None) -> CompactCrops:
    """Host prep with no padding: the crops back to back, in queue order,
    as float32 (what :func:`lay_out_slots` lays out into
    :func:`pack_plan_host`'s slots on the device).

    ``out``: a 1-d float32 array to write into (a reused staging buffer),
    at least the crops' size; None allocates one.  A crop larger than the
    plan's slot raises before anything is written.
    """
    c = frame_pixels[0].shape[-1] if frame_pixels else 3
    hw = np.array([px.shape[:2] for px in frame_pixels],
                  np.int64).reshape(-1, 2)
    for i, (h, w) in enumerate(hw.tolist()):
        if h > plan.hmax or w > plan.wmax:
            raise ValueError(f"crop {i} ({h}x{w}) exceeds the plan's slot "
                             f"({plan.hmax}x{plan.wmax})")
    sizes = hw[:, 0] * hw[:, 1] * c
    total = int(sizes.sum())
    if out is None:
        out = np.empty(total, np.float32)
    elif out.dtype != np.float32 or out.ndim != 1 or out.size < total:
        raise ValueError(f"out must be 1-d float32 of at least {total} "
                         f"elements, got {out.dtype} {out.shape}")
    packed = CompactCrops(out[:total], np.cumsum(sizes) - sizes, hw, c)
    for i, px in enumerate(frame_pixels):
        packed.crop(i)[...] = px
    return packed


def lay_out_slots(flat: torch.Tensor, packed: CompactCrops,
                  plan: BatchPlan) -> torch.Tensor:
    """``flat`` (``packed.flat`` on any device) -> the plan's (slot_capacity,
    hmax, wmax, C) float32 slots on that device, zero-padded: equal to
    :func:`pack_plan_host` of the same crops, padding included.  One
    copy a crop, on the device."""
    c = packed.channels
    slots = torch.zeros((plan.slot_capacity, plan.hmax, plan.wmax, c),
                        dtype=torch.float32, device=flat.device)
    for i, (o, (h, w)) in enumerate(zip(packed.offsets.tolist(),
                                        packed.hw.tolist())):
        slots[i, :h, :w] = flat[o:o + h * w * c].view(h, w, c)
    return slots


def route_detections(plan: BatchPlan, patches: Sequence[Patch],
                     obj: np.ndarray, boxes: np.ndarray,
                     obj_threshold: float = 0.5
                     ) -> Dict[int, List[Tuple[float, Tuple[float, ...]]]]:
    """Route canvas-space detector outputs back to their source frames.

    obj: (B, s, s) objectness, boxes: (B, s, s, 4) xyxy in canvas pixels.
    A detection belongs to the placement whose rectangle contains its box
    centre; its box is clipped to the placement and translated to the
    patch's frame coordinates.  Returns {frame_id: [(score, box_xyxy)]}.
    """
    obj = np.asarray(obj, np.float32)
    boxes = np.asarray(boxes, np.float32)
    b = obj.shape[0]
    bcx = (boxes[..., 0] + boxes[..., 2]) / 2     # (B, s, s) box centres
    bcy = (boxes[..., 1] + boxes[..., 3]) / 2

    out: Dict[int, List[Tuple[float, Tuple[float, ...]]]] = {}
    for bi, patch_idx, x, y, w, h in plan.placements():
        if bi >= b:
            continue
        patch = patches[patch_idx]
        hit = ((obj[bi] >= obj_threshold)
               & (bcx[bi] >= x) & (bcx[bi] < x + w)
               & (bcy[bi] >= y) & (bcy[bi] < y + h))
        if not hit.any():
            continue
        dx = patch.x0 - x
        dy = patch.y0 - y
        dests = out.setdefault(patch.frame_id, [])
        for score, bx in zip(obj[bi][hit], boxes[bi][hit]):
            # clip to the placement rect: pixels past it belong to a
            # neighbouring placement (possibly another frame entirely)
            x0 = min(max(float(bx[0]), x), x + w)
            y0 = min(max(float(bx[1]), y), y + h)
            x1 = min(max(float(bx[2]), x), x + w)
            y1 = min(max(float(bx[3]), y), y + h)
            dests.append((float(score),
                          (x0 + dx, y0 + dy, x1 + dx, y1 + dy)))
    return out


def route_fused(plan: BatchPlan, patches: Sequence[Patch],
                fused: np.ndarray, obj_threshold: float = 0.5
                ) -> Dict[int, List[Tuple[float, Tuple[float, ...]]]]:
    """Route :func:`unstitch_decode` outputs back to their source frames.

    fused: (num_patches, s, s, 5) per-slot decoded grids, already assigned
    to placements, clipped and placement-local, so routing thresholds each
    slot's grid and adds the patch's frame origin.  Emits detections in
    the same per-frame order as :func:`route_detections`.
    """
    fused = np.asarray(fused, np.float32)
    out: Dict[int, List[Tuple[float, Tuple[float, ...]]]] = {}
    for _, patch_idx, _, _, _, _ in plan.placements():
        if patch_idx >= fused.shape[0]:
            continue
        grid = fused[patch_idx]
        hit = grid[..., 0] >= obj_threshold
        if not hit.any():
            continue
        patch = patches[patch_idx]
        dx = float(patch.x0)
        dy = float(patch.y0)
        dests = out.setdefault(patch.frame_id, [])
        for row in grid[hit]:
            dests.append((float(row[0]),
                          (float(row[1]) + dx, float(row[2]) + dy,
                           float(row[3]) + dx, float(row[4]) + dy)))
    return out
