"""The benchmark's own operation and byte counts, and the card's peaks.

Counted from shapes and records, never read from the program, so that a
change to the program cannot move them.  Peaks are NVIDIA's H100 SXM
data sheet (dense, no sparsity), stated at the full 700 W limit.
"""
from __future__ import annotations

import numpy as np

from tangram_bench import families

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def detector_flops_per_canvas(cfg: dict) -> float:
    """Multiply-adds x 2 of one canvas through the detector, as the
    configuration's family counts them (``flops_per_canvas``)."""
    return families.load(cfg).flops_per_canvas(cfg)


def touched_tokens(records: np.ndarray, canvas: int, patch: int) -> int:
    """Tokens that hold a placed pixel, summed over the canvases."""
    side = canvas // patch
    total = 0
    for per_canvas in records:
        grid = np.zeros((side, side), bool)
        for valid, _, x, y, w, h in per_canvas.tolist():
            if valid > 0 and w > 0 and h > 0:
                grid[y // patch:(y + h - 1) // patch + 1,
                     x // patch:(x + w - 1) // patch + 1] = True
        total += int(grid.sum())
    return total


def k4_work(records: np.ndarray, cfg: dict) -> tuple:
    """(operations, bytes) that K4's inputs need: the projection of every
    token a placed pixel touches (a token of empty canvas is the bias
    alone), the records, each placed float32 pixel read once, the bf16
    weights and bias, and every bf16 token written once."""
    d, p = cfg["d_model"], cfg["patch"]
    k_dim = p * p * 3
    s = (cfg["canvas"] // p) ** 2
    valid = records[records[..., 0] > 0]
    placed = int((valid[:, 4].astype(np.int64) * valid[:, 5]).sum())
    ops = 2.0 * touched_tokens(records, cfg["canvas"], p) * k_dim * d
    nbytes = (records.size * 4 + placed * 3 * 4 + (k_dim * d + d) * 2
              + records.shape[0] * s * d * 2)
    return ops, float(nbytes)


def k4_bound_s(records: np.ndarray, cfg: dict) -> float:
    """K4's least time on the card: the larger of its operations at the
    bf16 peak and its bytes at the HBM bandwidth."""
    ops, nbytes = k4_work(records, cfg)
    return max(ops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
