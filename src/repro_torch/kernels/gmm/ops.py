"""Public entry for the GMM background-model update.

Port of ``repro/kernels/gmm/ops.py``.  ``impl`` picks the implementation:
``"cuda"`` launches the hand-written kernel K5, ``"torch"`` runs the plain
version.  The default follows the frame's device, so a CUDA tensor always
reaches the kernel and a CPU tensor (the tests) the plain version;
``impl="cuda"`` on a CPU tensor raises, and so does the kernel on inputs
that require grad (``launches.refuse_grad``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gmm import GMMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gmm.gmm import STATE_KEYS, gmm_update_cuda
from repro_torch.kernels.gmm.ref import gmm_update_reference
from repro_torch.kernels.launches import refuse_grad

IMPLS = ("cuda", "torch")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``None`` -> by device; otherwise a checked name (``"cuda"`` only for
    a CUDA tensor)."""
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown gmm impl {impl!r}; choose from "
                         f"{list(IMPLS)}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"gmm impl 'cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    return impl


def gmm_update(state: dict, frame: torch.Tensor,
               cfg: GMMConfig = GMMConfig(), impl: Optional[str] = None
               ) -> Tuple[dict, torch.Tensor]:
    """One streaming update: (new state, foreground mask (H, W) bool)."""
    if resolve_impl(impl, frame) == "cuda":
        refuse_grad("gmm_update", frame, *state.values())
        return gmm_update_cuda(state, frame, cfg)
    return gmm_update_reference(state, frame, cfg)


def state_from_numpy(state: dict, device: DeviceLike = None) -> dict:
    """A mixture state of numpy arrays (e.g. the JAX package's, through
    ``np.asarray``) as the port's float32 tensors on ``device``."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(state[k], np.float32)).to(device)
            for k in STATE_KEYS}
