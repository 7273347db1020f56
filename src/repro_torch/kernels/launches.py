"""Launch counts of the port's hand-written kernels, in one place.

Each wrapper calls :func:`count_launch` where it launches its kernel, and
nowhere else, so a run can show that its path went through the kernels:
K1/K2 in :mod:`.stitch.stitch`, K4/K3 in :mod:`.stitch.fused_embed`, K5 in
:mod:`.gmm.gmm` and K6/K7 in :mod:`.attention.flash`.  A launch is one
kernel on the card.  Shard threads launch concurrently, so the increment
takes a lock: a plain ``+=`` on the dict can lose a count.

No kernel has a backward pass (the JAX package's have none either), so a
kernel's output would carry no gradient: each dispatcher that resolves to
a kernel calls :func:`refuse_grad` first, which raises instead.
"""
from __future__ import annotations

import threading

import torch

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


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if gradients are being recorded and a floating input of
    ``kernel`` requires one: its output would silently carry none."""
    if torch.is_grad_enabled() and any(
            t.requires_grad and t.is_floating_point() for t in tensors):
        raise RuntimeError(
            f"kernel {kernel!r} has no backward pass (the JAX package's "
            f"has none either); an input requires grad, so its gradient "
            f"would be lost. Run the plain version (impl='torch') or the "
            f"training paths (impl='xla'), or call it under "
            f"torch.no_grad()")
