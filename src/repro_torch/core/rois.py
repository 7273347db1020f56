"""Foreground mask -> RoI bounding boxes (plain PyTorch).

Port of ``extract_rois`` from ``repro/core/rois.py``:

1. max-pool downsample the mask by ``downsample`` (small objects survive),
2. morphological dilation (``dilate`` rounds of 3x3-cross max),
3. connected components by iterative min-label propagation to a fixpoint,
4. per-component bbox via scatter-min/max, keeping the ``max_rois``
   largest components by pixel count.

Step 3 is a Python loop with one ``.any()`` host sync per step (the
reference runs it as ``lax.while_loop`` on the device).  Step 4 orders
components with a stable descending sort, which breaks count ties by the
lower label first, exactly as ``jax.lax.top_k`` does; ``torch.topk``
promises no order on ties.

:func:`numpy_rois` is the reference's independent numpy implementation
(a two-pass flood fill), the oracle the tests hold ``extract_rois`` to.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    downsample: int = 8
    dilate: int = 2
    max_rois: int = 64
    min_area: int = 2          # in downsampled cells

    def degraded(self, factor: int = 2) -> "RoIConfig":
        """A reduced-quality variant for source-side overload response:
        coarser grid, fewer components."""
        return dataclasses.replace(
            self, downsample=self.downsample * factor,
            max_rois=max(1, self.max_rois // factor))


def _maxpool(mask: torch.Tensor, k: int) -> torch.Tensor:
    h, w = mask.shape
    m = mask[: h - h % k, : w - w % k]
    return m.reshape(h // k, k, w // k, k).any(dim=3).any(dim=1)


def _dilate(mask: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        p = F.pad(mask, (1, 1, 1, 1))
        mask = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
                | p[1:-1, 1:-1])
    return mask


def _label(mask: torch.Tensor) -> torch.Tensor:
    """Connected components (4-neighbourhood) via min-label propagation;
    background cells carry label h*w."""
    h, w = mask.shape
    bg = h * w
    labels = torch.where(
        mask, torch.arange(bg, dtype=torch.int32,
                           device=mask.device).reshape(h, w), bg)
    while True:
        p = F.pad(labels, (1, 1, 1, 1), value=bg)
        nbr = torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                            torch.minimum(p[1:-1, :-2], p[1:-1, 2:]))
        new = torch.where(mask, torch.minimum(labels, nbr), bg)
        if not bool((new != labels).any()):
            return new
        labels = new


def extract_rois(mask: torch.Tensor, cfg: RoIConfig = RoIConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask: (H, W) bool -> (boxes (max_rois, 4) int32 xyxy in full-res
    pixels, valid (max_rois,) bool), both on the mask's device."""
    ds = cfg.downsample
    small = _dilate(_maxpool(mask, ds), cfg.dilate)
    hd, wd = small.shape
    labels = _label(small)

    n = hd * wd
    dev = mask.device
    flat = labels.reshape(-1).long()
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    ys, xs = idx // wd, idx % wd
    valid_px = flat < n

    def scatter(init, src, reduce):
        out = torch.full((n + 1,), init, dtype=torch.int32, device=dev)
        return out.scatter_reduce(0, flat, src, reduce=reduce)

    count = scatter(0, torch.ones_like(idx), "sum")
    x0 = scatter(wd, torch.where(valid_px, xs, wd), "amin")
    y0 = scatter(hd, torch.where(valid_px, ys, hd), "amin")
    x1 = scatter(0, torch.where(valid_px, xs, 0), "amax")
    y1 = scatter(0, torch.where(valid_px, ys, 0), "amax")
    count[n] = 0                                        # background bucket

    order = torch.sort(count[:-1], descending=True, stable=True).indices
    top_idx = order[:cfg.max_rois]
    top_count = count[top_idx]
    valid = top_count >= cfg.min_area
    boxes = torch.stack([x0[top_idx] * ds, y0[top_idx] * ds,
                         (x1[top_idx] + 1) * ds, (y1[top_idx] + 1) * ds],
                        dim=-1).to(torch.int32)
    return boxes * valid[:, None], valid


# ------------------------------------------------------------- reference ----

def numpy_rois(mask: np.ndarray, cfg: RoIConfig = RoIConfig()):
    """Reference implementation with a classic two-pass flood fill."""
    ds = cfg.downsample
    h, w = mask.shape
    small = mask[: h - h % ds, : w - w % ds].reshape(
        h // ds, ds, w // ds, ds).any(axis=(1, 3))
    for _ in range(cfg.dilate):
        p = np.pad(small, 1)
        small = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
                 | p[1:-1, 1:-1])
    hd, wd = small.shape
    labels = -np.ones((hd, wd), np.int32)
    comps = []
    for i in range(hd):
        for j in range(wd):
            if small[i, j] and labels[i, j] < 0:
                stack = [(i, j)]
                labels[i, j] = len(comps)
                px = []
                while stack:
                    y, x = stack.pop()
                    px.append((y, x))
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        yy, xx = y + dy, x + dx
                        if 0 <= yy < hd and 0 <= xx < wd and small[yy, xx] \
                                and labels[yy, xx] < 0:
                            labels[yy, xx] = len(comps)
                            stack.append((yy, xx))
                comps.append(px)
    comps.sort(key=len, reverse=True)
    boxes, valid = [], []
    for px in comps[: cfg.max_rois]:
        if len(px) < cfg.min_area:
            continue
        ys = [p[0] for p in px]
        xs = [p[1] for p in px]
        boxes.append((min(xs) * ds, min(ys) * ds,
                      (max(xs) + 1) * ds, (max(ys) + 1) * ds))
        valid.append(True)
    return np.array(boxes, np.int32).reshape(-1, 4), np.array(valid, bool)
