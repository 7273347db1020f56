"""Launch counts of the port's hand-written kernels, in one place.

Each wrapper adds one to its kernel's entry where it launches the kernel,
and nowhere else, so a run can show that its path went through the
kernels: K1/K2 in :mod:`.stitch.stitch`, K4/K3 in :mod:`.stitch.fused_embed`,
K5 in :mod:`.gmm.gmm` and K6/K7 in :mod:`.attention.flash`.  A launch is
one kernel on the card.
"""
from __future__ import annotations

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"stitch": 0, "unstitch": 0, "stitch_embed": 0,
            "unstitch_decode": 0, "gmm_update": 0, "flash_attention": 0,
            "flash_decode": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
