"""Plain PyTorch versions of the canvas stitch / unstitch kernels and of
the fused stitch->embed and decode->gather kernels.

Counterpart of ``repro/kernels/stitch/ref.py``.  Patches live in padded
slots ``patch_pixels (P, Hmax, Wmax, C)`` with per-placement records
``records (B, K, 6) int32 = (valid, slot, x, y, w, h)``.  Stitch copies each
valid placement's (h, w) region to (y, x) of its canvas; every other pixel is
zero.  Unstitch gathers each valid placement back into a zero-padded
``(num_patches, hmax, wmax, C)`` slot array; slots no valid record references
stay zero.

The packer's placements lie inside the canvas, never overlap, and fit their
slot (property-tested in the reference), so a plain slice copy per record is
the whole function: the reference's clamp-and-roll window reduces to it.
These versions run on the CPU tests' path and are what ``chip_smoke.py``
holds the CUDA kernels against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.vit import patchify


def _valid_records(records: torch.Tensor):
    """Valid (b, slot, x, y, w, h) tuples, read on the host."""
    for bi, per_canvas in enumerate(records.tolist()):
        for valid, slot, x, y, w, h in per_canvas:
            if valid > 0:
                yield bi, slot, x, y, w, h


def stitch_reference(patch_pixels: torch.Tensor, records: torch.Tensor,
                     m: int, n: int) -> torch.Tensor:
    """(P, Hmax, Wmax, C) slots + (B, K, 6) records -> (B, M, N, C)."""
    c = patch_pixels.shape[-1]
    b = records.shape[0]
    out = torch.zeros((b, m, n, c), dtype=patch_pixels.dtype,
                      device=patch_pixels.device)
    for bi, slot, x, y, w, h in _valid_records(records):
        out[bi, y:y + h, x:x + w] = patch_pixels[slot, :h, :w]
    return out


def unstitch_reference(canvases: torch.Tensor, records: torch.Tensor,
                       num_patches: int, hmax: int, wmax: int
                       ) -> torch.Tensor:
    """(B, M, N, C) canvases + records -> (num_patches, hmax, wmax, C)."""
    c = canvases.shape[-1]
    out = torch.zeros((num_patches, hmax, wmax, c), dtype=canvases.dtype,
                      device=canvases.device)
    for bi, slot, x, y, w, h in _valid_records(records):
        if slot < num_patches:
            out[slot, :h, :w] = canvases[bi, y:y + h, x:x + w]
    return out


def stitch_embed_reference(patch_pixels: torch.Tensor, records: torch.Tensor,
                           kernel: torch.Tensor, bias: torch.Tensor,
                           m: int, n: int, patch: int) -> torch.Tensor:
    """Fused stitch -> patchify -> patch embed: (B, seq, d) in
    ``kernel.dtype``.  The stitched float32 canvas is rounded to the
    kernel dtype, multiplied with float32 accumulation (products of two
    bf16 values are exact in float32), the bias added in float32, and the
    sum rounded once."""
    canvases = stitch_reference(patch_pixels, records, m, n)
    x = patchify(canvases, patch).to(kernel.dtype).float()
    y = torch.matmul(x, kernel.float()) + bias.float()
    return y.to(kernel.dtype)


def unstitch_decode_reference(raw: torch.Tensor, records: torch.Tensor,
                              patch: int, num_patches: int) -> torch.Tensor:
    """Fused head decode + placement gather.

    raw: (B, side_m, side_n, 5) raw head outputs.  Each cell is decoded
    (sigmoid objectness, centre ``(g + sigmoid) * patch``, size
    ``exp(clip(., -6, 6)) * patch``) and kept in the slot of the placement
    that contains its decoded centre, with its box clipped to the
    placement in placement-local xyxy pixels.  Every other cell, and every
    slot no valid record references, is zero.  Returns
    (num_patches, side_m, side_n, 5) float32.
    """
    b, side_m, side_n, _ = raw.shape
    out = torch.zeros((num_patches, side_m, side_n, 5), dtype=torch.float32,
                      device=raw.device)
    if num_patches == 0:
        return out
    cell = float(patch)
    gy, gx = torch.meshgrid(
        torch.arange(side_m, dtype=torch.float32, device=raw.device),
        torch.arange(side_n, dtype=torch.float32, device=raw.device),
        indexing="ij")
    r = raw.to(torch.float32)
    obj = torch.sigmoid(r[..., 0])
    cx = (gx + torch.sigmoid(r[..., 1])) * cell
    cy = (gy + torch.sigmoid(r[..., 2])) * cell
    bw = torch.exp(torch.clamp(r[..., 3], -6, 6)) * cell
    bh = torch.exp(torch.clamp(r[..., 4], -6, 6)) * cell
    for bi, slot, x, y, w, h in _valid_records(records):
        if slot >= num_patches:
            continue
        x0, y0, x1, y1 = float(x), float(y), float(x + w), float(y + h)
        hit = ((cx[bi] >= x0) & (cx[bi] < x1)
               & (cy[bi] >= y0) & (cy[bi] < y1))
        dec = torch.stack([
            obj[bi],
            torch.clamp(cx[bi] - bw[bi] / 2, x0, x1) - x0,
            torch.clamp(cy[bi] - bh[bi] / 2, y0, y1) - y0,
            torch.clamp(cx[bi] + bw[bi] / 2, x0, x1) - x0,
            torch.clamp(cy[bi] + bh[bi] / 2, y0, y1) - y0,
        ], dim=-1)
        out[slot] = torch.where(hit[..., None], dec, torch.zeros_like(dec))
    return out
