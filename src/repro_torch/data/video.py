"""Transmission byte model, bandwidth-shaped patch arrival, recordings.

Port of ``repro/data/video.py`` (numpy and plain Python).  Compressed
sizes follow a bits-per-pixel model, calibrated so a 3840x2160 frame is
~1.0 MB:

    patch bytes  = header + area * BPP_FG
    frame bytes  = header + W*H * BPP_FULL
    masked bytes = header + fg_area * BPP_FG + (W*H - fg_area) * BPP_BG

:class:`Uplink` is one camera's FIFO link shaping patches as they are
produced; :func:`shape_arrivals` shapes a whole per-camera list through it.
:func:`load_frames` reads a recorded frame sequence for
:class:`repro_torch.sources.FileStreamSource`.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Sequence, Union

import numpy as np

from repro_torch.core.partitioning import Patch

BPP_FULL = 0.125      # bytes/pixel, full-frame intra coding
BPP_FG = 0.25         # bytes/pixel, high-quality RoI crops
BPP_BG_MASKED = 0.01  # bytes/pixel, masked (uniform) background
HEADER_BYTES = 256


def patch_bytes(p: Patch) -> float:
    return HEADER_BYTES + p.area * BPP_FG


def frame_bytes(width: int, height: int) -> float:
    return HEADER_BYTES + width * height * BPP_FULL


def masked_frame_bytes(width: int, height: int, fg_area: int) -> float:
    bg = width * height - fg_area
    return HEADER_BYTES + fg_area * BPP_FG + bg * BPP_BG_MASKED


@dataclasses.dataclass
class Arrival:
    t_arrive: float
    patch: Patch
    n_bytes: float


class Uplink:
    """One camera's FIFO uplink: arrival time = max(t_gen, link free) +
    bytes / bandwidth, patches serialised in send order, with running
    byte/transmission totals."""

    def __init__(self, bandwidth_bps: float):
        if bandwidth_bps <= 0:
            raise ValueError(f"bandwidth must be positive, got "
                             f"{bandwidth_bps}")
        self.byte_rate = bandwidth_bps / 8.0
        self.link_free = 0.0
        self.bytes_sent = 0.0
        self.transmission_seconds = 0.0
        self.n_sent = 0

    def send(self, p: Patch) -> Arrival:
        b = patch_bytes(p)
        start = max(p.t_gen, self.link_free)
        t_arr = start + b / self.byte_rate
        self.link_free = t_arr
        self.bytes_sent += b
        self.transmission_seconds += t_arr - p.t_gen
        self.n_sent += 1
        return Arrival(t_arr, p, b)


def shape_arrivals(patches: Sequence[Patch], bandwidth_bps: float
                   ) -> List[Arrival]:
    """FIFO uplink over one camera's patches (in generation order)."""
    link = Uplink(bandwidth_bps)
    return [link.send(p) for p in patches]


def merge_arrivals(per_camera: Sequence[List[Arrival]]) -> List[Arrival]:
    out = [a for cam in per_camera for a in cam]
    out.sort(key=lambda a: a.t_arrive)
    return out


def load_frames(path: Union[str, pathlib.Path]) -> np.ndarray:
    """Read a recorded frame sequence into a (T, H, W) float32 stack.

    Accepts a ``.npy`` stack, an ``.npz`` archive (the array named
    ``frames``, else the first), or a directory of per-frame ``.npy`` files
    (lexicographic order).  RGB stacks (T, H, W, 3) are collapsed to
    luminance (the channel mean); a recording whose values exceed 1.5 is
    taken as 8-bit and rescaled from [0, 255] to [0, 1].
    """
    path = pathlib.Path(path)
    if path.is_dir():
        files = sorted(path.glob("*.npy"))
        if not files:
            raise ValueError(f"no .npy frames in directory {path}")
        frames = np.stack([np.load(f) for f in files])
    elif path.suffix == ".npz":
        with np.load(path) as z:
            key = "frames" if "frames" in z.files else z.files[0]
            frames = z[key]
    else:
        frames = np.load(path)
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.ndim == 4:                      # RGB -> luminance
        frames = frames.mean(axis=-1)
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W[, 3]) frames, got shape "
                         f"{frames.shape}")
    frames = frames.astype(np.float32)
    if frames.max(initial=0.0) > 1.5:         # 8-bit recording
        frames = frames / 255.0
    return frames
