"""Striped-lock refcounted frame store for the device executors.

Port of ``repro/core/framestore.py``.  ``add`` registers a frame with one
reference per patch cut from it, ``release`` drops one at completion
delivery, and the frame is evicted when its last patch has been routed.
Frame ids hash onto independent ``(lock, frames, refs)`` stripes, so
threads touching different frames rarely contend.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["FrameStore"]


class FrameStore:
    """Refcounted pixel store with striped locks (thread-safe)."""

    def __init__(self, n_stripes: int = 16):
        if n_stripes < 1:
            raise ValueError(f"n_stripes must be >= 1, got {n_stripes}")
        self.n_stripes = n_stripes
        self._stripes = [(threading.Lock(), {}, {})
                         for _ in range(n_stripes)]

    def _stripe(self, frame_id):
        return self._stripes[hash(frame_id) % self.n_stripes]

    def add(self, frame_id, pixels, n_patches: int) -> None:
        """Register a frame the edge cut ``n_patches`` patches from.
        Frames that produced no patches are not stored at all."""
        if n_patches <= 0:
            return
        lock, frames, refs = self._stripe(frame_id)
        with lock:
            frames[frame_id] = pixels
            refs[frame_id] = refs.get(frame_id, 0) + n_patches

    def get(self, frame_id) -> Optional[object]:
        """The frame's pixels, or None once evicted / never stored."""
        lock, frames, _ = self._stripe(frame_id)
        with lock:
            return frames.get(frame_id)

    def release(self, frame_id) -> None:
        """Drop one patch reference; evict the frame at zero."""
        lock, frames, refs = self._stripe(frame_id)
        with lock:
            left = refs.get(frame_id)
            if left is None:
                return
            if left <= 1:
                del refs[frame_id]
                frames.pop(frame_id, None)
            else:
                refs[frame_id] = left - 1

    def __len__(self) -> int:
        return sum(len(frames) for _, frames, _ in self._stripes)

    def __contains__(self, frame_id) -> bool:
        lock, frames, _ = self._stripe(frame_id)
        with lock:
            return frame_id in frames

    def snapshot(self) -> Dict:
        """Point-in-time ``{frame_id: pixels}`` copy (tests/diagnostics)."""
        out: Dict = {}
        for lock, frames, _ in self._stripes:
            with lock:
                out.update(frames)
        return out
