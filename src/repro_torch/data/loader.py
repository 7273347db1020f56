"""Host-side training data loaders: detector training and synthetic LM
data.

Port of ``repro/data/loader.py``, in numpy on the host: deterministic,
seeded, prefetch-free; each yields a dict of numpy arrays (the training
driver copies it to the device).  Both equal the JAX package's loaders bit
for bit for the same arguments.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.core import partitioning, stitching
from repro_torch.data.synthetic import Scene, preset


def detector_batches(canvas: int, batch: int, max_boxes: int = 64,
                     seed: int = 0, scene_idx: int = 0,
                     n_batches: Optional[int] = None) -> Iterator[dict]:
    """Stitched-canvas detection batches from a synthetic scene.

    Runs the real edge pipeline (scene -> ground-truth boxes -> Algorithm
    1 -> stitching) on a ``2 canvas x canvas`` scene (preset
    ``scene_idx``, 10 fps) and composites patch pixels onto canvases,
    yielding {canvases (B, canvas, canvas, 3) float32, boxes (B,
    max_boxes, 4) float32 in canvas coordinates, valid (B, max_boxes)
    bool}.  The scene is fixed by ``scene_idx``; ``seed`` is accepted for
    the reference's interface and draws nothing, as there.
    """
    scene = Scene(preset(scene_idx, width=canvas * 2, height=canvas,
                         fps=10.0))
    made = 0
    while n_batches is None or made < n_batches:
        canvases_px = np.zeros((batch, canvas, canvas, 3), np.float32)
        boxes_out = np.zeros((batch, max_boxes, 4), np.float32)
        valid_out = np.zeros((batch, max_boxes), bool)
        b = 0
        while b < batch:
            scene.step()
            frame = scene.render_rgb()
            gt = scene.boxes()
            patches = partitioning.partition_host(
                gt, scene.cfg.width, scene.cfg.height, 4, 4,
                frame_id=scene.t)
            if not patches:
                continue
            for cv in stitching.stitch(patches, canvas, canvas):
                if b >= batch:
                    break
                k = 0
                for pl in cv.placements:
                    p = patches[pl.patch_idx]
                    canvases_px[b, pl.y:pl.y + pl.h, pl.x:pl.x + pl.w] = \
                        frame[p.y0:p.y1, p.x0:p.x1]
                    # ground-truth boxes inside this patch, in canvas
                    # coordinates
                    for (x0, y0, x1, y1) in gt:
                        if k >= max_boxes:
                            break
                        if x0 >= p.x0 and y0 >= p.y0 and x1 <= p.x1 \
                                and y1 <= p.y1:
                            boxes_out[b, k] = (x0 - p.x0 + pl.x,
                                               y0 - p.y0 + pl.y,
                                               x1 - p.x0 + pl.x,
                                               y1 - p.y0 + pl.y)
                            valid_out[b, k] = True
                            k += 1
                b += 1
        yield {"canvases": canvases_px, "boxes": boxes_out,
               "valid": valid_out}
        made += 1


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               n_batches: Optional[int] = None) -> Iterator[dict]:
    """Synthetic LM batches: Zipf(1.3) tokens clipped into the vocabulary,
    labels the tokens rolled one to the left."""
    rng = np.random.default_rng(seed)
    made = 0
    while n_batches is None or made < n_batches:
        base = rng.zipf(1.3, size=(batch, seq)).clip(0, vocab - 1)
        tokens = base.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        yield {"tokens": tokens, "labels": labels}
        made += 1
