"""Config dataclasses for the detector, its ViT trunk, and the card.

Port of the parts of ``repro/config.py`` the serving path needs.
``dtype_of`` maps the configs' dtype names to torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT encoder (the detector's trunk)."""

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    in_channels: int = 3
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """ViT-backbone anchor-free detector for the Tangram pipeline."""

    name: str
    canvas: int = 1024
    patch: int = 32
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def n_tokens(self) -> int:
        side = self.canvas // self.patch
        return side * side

    @property
    def n_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        return (self.n_layers * per_layer + 3 * self.patch**2 * d + d * 5
                + self.n_tokens * d)


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """NVIDIA H100 SXM data-sheet constants (dense, no sparsity, at the
    700 W power limit) used by the analytical latency model and the
    kernels' byte bounds.  A card set below 700 W runs slower."""

    peak_flops: float = 989e12       # bf16 tensor-core FLOP/s per card
    hbm_bw: float = 3.35e12          # HBM3 bytes/s per card
    nvlink_bw: float = 450e9         # NVLink bytes/s each way per card
    hbm_bytes: int = 80 * 1024**3    # device memory per card


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
