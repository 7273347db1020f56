"""ViT encoder pieces the detector trunk runs.

Port of ``patchify`` and ``_encoder`` from ``repro/models/vit.py``.  The
per-layer parameters are a list (the JAX tree stacks them on a leading
``n_layers`` axis for ``lax.scan``; here the encoder is a Python loop).
"""
from __future__ import annotations

import torch

from repro_torch.config import ViTConfig, dtype_of
from repro_torch.models import attention as attn
from repro_torch.models import layers


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C), the JAX package's layout."""
    b, hh, ww, c = images.shape
    h, w = hh // patch, ww // patch
    x = images.reshape(b, h, patch, w, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def encoder(cfg: ViTConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm transformer blocks over ``params["layers"]``, then the
    final layernorm."""
    cdt = dtype_of(cfg.compute_dtype)
    for lp in params["layers"]:
        h = layers.layernorm(lp["ln1"], x, cfg.norm_eps, cdt)
        x = x + attn.encoder_attention(lp["attn"], h, compute_dtype=cdt)
        h = layers.layernorm(lp["ln2"], x, cfg.norm_eps, cdt)
        x = x + layers.gelu_mlp(lp["mlp"], h, cdt)
    return layers.layernorm(params["ln_f"], x, cfg.norm_eps, cdt)
