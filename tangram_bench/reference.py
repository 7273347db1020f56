"""The plain reference of the fused serving path, in float32 PyTorch.

It imports nothing of the program.  From the patches of one invocation
(their sizes, in queue order), the frames' pixels and the weights, it
works the invocation out again:

* ``plan``: the guillotine packer (best-short-side fit, bottom-left
  placement, split on the free rectangle's shorter axis, a new canvas
  when nothing fits) and the flattened records ``(B, K, 6) = (valid,
  slot, x, y, w, h)``, with the slot extents, the slot count and K
  bucketed to powers of two;
* ``stitch`` + ``embed``: the crops placed on zero canvases, cut into
  patches and projected, in float32;
* the trunk and its 5-channel head are the configuration's family's
  (``families/<family>.py``'s ``detector_raw``), built from this
  module's ``layernorm`` and products, in float32 with TF32 off;
* ``decode_gather``: objectness and box decode, each cell kept in the
  placement that contains its centre, boxes clipped placement-local;
* ``route``: detections at objectness >= 0.5, moved to frame
  coordinates.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
OBJ_THRESHOLD = 0.5


# --------------------------------------------------------------- packer ----

def _choose(free, w, h):
    best, best_key = None, None
    for i, (fx, fy, fw, fh) in enumerate(free):
        if fw >= w and fh >= h:
            key = (min(fw - w, fh - h), fw * fh)
            if best_key is None or key < best_key:
                best, best_key = i, key
    return best


def _split(rect, w, h):
    x, y, cw, ch = rect
    out = []
    if cw <= ch:
        if cw - w > 0:
            out.append((x + w, y, cw - w, h))
        if ch - h > 0:
            out.append((x, y + h, cw, ch - h))
    else:
        if cw - w > 0:
            out.append((x + w, y, cw - w, ch))
        if ch - h > 0:
            out.append((x, y + h, w, ch - h))
    return out


def pack(sizes: Sequence[Tuple[int, int]], m: int, n: int
         ) -> List[List[Tuple[int, int, int, int, int]]]:
    """Patches ``(w, h)`` in queue order -> canvases, each a list of
    ``(patch_idx, x, y, w, h)``."""
    canvases: List[list] = []
    frees: List[list] = []
    for i, (w, h) in enumerate(sizes):
        if w > n or h > m:
            raise ValueError(f"patch {i} ({w}x{h}) exceeds the canvas")
        for ci, free in enumerate(frees):
            j = _choose(free, w, h)
            if j is not None:
                rect = free.pop(j)
                canvases[ci].append((i, rect[0], rect[1], w, h))
                free.extend(_split(rect, w, h))
                break
        else:
            rect = (0, 0, n, m)
            canvases.append([(i, 0, 0, w, h)])
            frees.append(_split(rect, w, h))
    return canvases


def _pow2(x: int, cap: int) -> int:
    x = max(x, 1)
    return min(1 << (x - 1).bit_length(), cap)


def plan(sizes: Sequence[Tuple[int, int]], m: int, n: int) -> dict:
    """The packing flattened into device records."""
    canvases = pack(sizes, m, n)
    k = _pow2(max((len(c) for c in canvases), default=1), 1 << 30)
    records = np.zeros((len(canvases), k, 6), np.int32)
    for bi, placed in enumerate(canvases):
        for ki, (i, x, y, w, h) in enumerate(placed):
            records[bi, ki] = (1, i, x, y, w, h)
    return {"records": records,
            "hmax": _pow2(max((h for _, h in sizes), default=1), m),
            "wmax": _pow2(max((w for w, _ in sizes), default=1), n),
            "slot_capacity": _pow2(len(sizes), 1 << 30),
            "canvases": canvases}


def placements(records: np.ndarray):
    """(b, slot, x, y, w, h) of the valid records, in (b, k) order."""
    for bi in range(records.shape[0]):
        for valid, slot, x, y, w, h in records[bi].tolist():
            if valid > 0:
                yield bi, slot, x, y, w, h


# ------------------------------------------------------ stitch, embed ----

def stitch(crops: Sequence[np.ndarray], records: np.ndarray, m: int, n: int,
           device: torch.device) -> torch.Tensor:
    """(B, m, n, 3) float32 canvases with each crop at its placement."""
    out = torch.zeros((records.shape[0], m, n, 3), dtype=torch.float32,
                      device=device)
    for bi, slot, x, y, w, h in placements(records):
        crop = torch.from_numpy(np.ascontiguousarray(crops[slot][:h, :w]))
        out[bi, y:y + h, x:x + w] = crop.to(device, torch.float32)
    return out


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, tokens, patch * patch * C), tokens row-major,
    each token's pixels row-major with channels last."""
    b, hh, ww, c = images.shape
    h, w = hh // patch, ww // patch
    x = images.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product (TF32 off under :func:`full_float32`)."""
    return a @ b


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The yardstick's product: both operands rounded to bf16, the sum in
    float32, as a bf16 tensor-core GEMM computes it."""
    return (a.to(torch.bfloat16).to(torch.float32)
            @ b.to(torch.bfloat16).to(torch.float32))


FP8_MAX = 448.0     # float8_e4m3fn's largest finite value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    absolute max at 448), back in float32: an fp8 product's operand."""
    scale = float(x.abs().max()) / FP8_MAX or 1.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands rounded to fp8, the sum in
    float32, as an fp8 tensor-core GEMM computes it."""
    return fp8(a) @ fp8(b)


def embed(canvases: torch.Tensor, weights: dict, patch: int, matmul=mm
          ) -> torch.Tensor:
    pe = weights["trunk"]["patch_embed"]
    return (matmul(patchify(canvases, patch), f32(pe["kernel"]))
            + f32(pe["bias"]))


# ------------------------------------------------- shared by the trunks ----

def layernorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), f32(p["scale"]), f32(p["bias"]),
                        eps)


@contextlib.contextmanager
def full_float32():
    """Float32 products as float32: TF32 off for the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ------------------------------------------------------- decode, route ----

def decode_gather(raw: torch.Tensor, records: np.ndarray, patch: int,
                  n_slots: int) -> torch.Tensor:
    """Raw head (B, s, s, 5) -> per-slot grids (n_slots, s, s, 5):
    objectness, then the box clipped to its placement, placement-local;
    zero where a cell's centre lies outside the slot's placement."""
    b, sm, sn, _ = raw.shape
    out = torch.zeros((n_slots, sm, sn, 5), dtype=torch.float32,
                      device=raw.device)
    gy, gx = torch.meshgrid(
        torch.arange(sm, dtype=torch.float32, device=raw.device),
        torch.arange(sn, dtype=torch.float32, device=raw.device),
        indexing="ij")
    r = f32(raw)
    cell = float(patch)
    obj = torch.sigmoid(r[..., 0])
    cx = (gx + torch.sigmoid(r[..., 1])) * cell
    cy = (gy + torch.sigmoid(r[..., 2])) * cell
    bw = torch.exp(torch.clamp(r[..., 3], -6, 6)) * cell
    bh = torch.exp(torch.clamp(r[..., 4], -6, 6)) * cell
    for bi, slot, x, y, w, h in placements(records):
        if slot >= n_slots:
            continue
        x0, y0, x1, y1 = float(x), float(y), float(x + w), float(y + h)
        hit = ((cx[bi] >= x0) & (cx[bi] < x1)
               & (cy[bi] >= y0) & (cy[bi] < y1))
        dec = torch.stack([
            obj[bi],
            torch.clamp(cx[bi] - bw[bi] / 2, x0, x1) - x0,
            torch.clamp(cy[bi] - bh[bi] / 2, y0, y1) - y0,
            torch.clamp(cx[bi] + bw[bi] / 2, x0, x1) - x0,
            torch.clamp(cy[bi] + bh[bi] / 2, y0, y1) - y0], dim=-1)
        out[slot] = torch.where(hit[..., None], dec, torch.zeros_like(dec))
    return out


def route(records: np.ndarray, origins: Sequence[Tuple[int, int, int]],
          grids: np.ndarray) -> Dict[int, list]:
    """Per-slot grids -> {frame_id: [(score, (x0, y0, x1, y1))]} in frame
    coordinates; ``origins[slot] = (frame_id, x0, y0)`` of the patch in
    that slot.  Placements are visited in (b, k) order, cells row-major."""
    out: Dict[int, list] = {}
    for _, slot, _, _, _, _ in placements(records):
        if slot >= grids.shape[0]:
            continue
        grid = grids[slot]
        rows = grid[grid[..., 0] >= OBJ_THRESHOLD]
        if not len(rows):
            continue
        frame_id, ox, oy = origins[slot]
        dx, dy = float(ox), float(oy)
        dests = out.setdefault(frame_id, [])
        for row in rows.tolist():
            dests.append((row[0], (row[1] + dx, row[2] + dy,
                                   row[3] + dx, row[4] + dy)))
    return out
