"""Plain PyTorch versions of the canvas stitch / unstitch kernels.

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
