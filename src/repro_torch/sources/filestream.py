"""Recorded frame sequences as a live source.

Port of ``repro/sources/filestream.py``.  :class:`FileStreamSource` plays
a recorded stack of frames (:func:`~repro_torch.data.video.load_frames`:
``.npy``/``.npz`` stack or a directory of per-frame ``.npy`` files) through
the same edge pipeline and rate clock as the synthetic camera - GMM (K5 on
the card), RoI extraction, Alg. 1 partitioning, FIFO uplink, overload
policy.  The recording loops when ``n_frames`` exceeds its length, so a
short clip can drive a long (or overload) run.  Frames of any size work,
4K included.
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.data.video import load_frames
from repro_torch.sources.camera import LiveSource


class FileStreamSource(LiveSource):
    """Replay a recorded frame stack through the live edge pipeline.
    Frame ids embed the camera id (``camera_id << 20 | frame index``);
    ``gmm_impl`` and the other keywords go to :class:`LiveSource`."""

    kind = "file"

    def __init__(self, path: Union[str, pathlib.Path],
                 n_frames: Optional[int] = None, canvas: int = 256,
                 **kwargs):
        self.frames = load_frames(path)
        t, height, width = self.frames.shape
        super().__init__(height, width,
                         n_frames if n_frames is not None else t,
                         canvas=canvas, **kwargs)

    def _frame(self, idx: int) -> Tuple[int, np.ndarray]:
        frame = self.frames[idx % len(self.frames)]
        return (self.camera_id << 20) | idx, frame
