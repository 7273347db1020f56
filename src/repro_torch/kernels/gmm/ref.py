"""Plain PyTorch oracle for the GMM update kernel = the core model itself.

Port of ``repro/kernels/gmm/ref.py``."""
from __future__ import annotations

from repro_torch.core.gmm import GMMConfig, update


def gmm_update_reference(state, frame, cfg: GMMConfig = GMMConfig()):
    return update(state, frame, cfg)
