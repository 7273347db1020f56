"""Launch counts of the port's hand-written kernels, in one place.

Each wrapper calls :func:`count_launch` where it launches its kernel, and
nowhere else, so a run can show that its path went through the kernels:
K1/K2 in :mod:`.stitch.stitch`, K4/K3 in :mod:`.stitch.fused_embed`, K5 in
:mod:`.gmm.gmm` and K6/K7 in :mod:`.attention.flash`.  A launch is one
kernel on the card.  Shard threads launch concurrently, so the increment
takes a lock: a plain ``+=`` on the dict can lose a count.
"""
from __future__ import annotations

import threading

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"stitch": 0, "unstitch": 0, "stitch_embed": 0,
            "unstitch_decode": 0, "gmm_update": 0, "flash_attention": 0,
            "flash_decode": 0}

_LOCK = threading.Lock()


def count_launch(kernel: str) -> None:
    """Add one launch of ``kernel`` (thread-safe)."""
    with _LOCK:
        LAUNCHES[kernel] += 1


def reset_launches() -> None:
    with _LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0
