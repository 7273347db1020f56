"""Shared primitive layers: dense, layernorm, GELU MLP.

Port of the parts of ``repro/models/layers.py`` the detector runs.
Functions take plain dicts of tensors laid out as in the JAX package
(dense kernels are (d_in, d_out)).  Norm statistics accumulate in float32
whatever the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(params: dict, x: torch.Tensor, compute_dtype: torch.dtype
          ) -> torch.Tensor:
    y = x.to(compute_dtype) @ params["kernel"].to(compute_dtype)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def layernorm(params: dict, x: torch.Tensor, eps: float,
              compute_dtype: torch.dtype) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if "scale" in params:
        y = (y * params["scale"].to(torch.float32)
             + params["bias"].to(torch.float32))
    return y.to(compute_dtype)


def gelu_mlp(params: dict, x: torch.Tensor, compute_dtype: torch.dtype
             ) -> torch.Tensor:
    # jax.nn.gelu(approximate=True) is the tanh approximation
    h = F.gelu(dense(params["fc1"], x, compute_dtype), approximate="tanh")
    return dense(params["fc2"], h, compute_dtype)
