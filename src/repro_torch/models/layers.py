"""Shared primitive layers: dense, norms, embeddings, MLPs.

Port of the parts of ``repro/models/layers.py`` the detector and the
decoder-only LM run (floating-point weights; int8 dense is ROADMAP item
8).  Functions take plain dicts of tensors laid out as in the JAX package
(dense kernels are (d_in, d_out)).  Norm statistics accumulate in float32
whatever the compute dtype.  ``*_specs`` build :class:`ParamSpec` subtrees
with the JAX package's init rules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.param import spec


# ----------------------------------------------------------------- specs ----

def dense_specs(d_in: int, d_out: int, *, dtype: torch.dtype) -> dict:
    return {"kernel": spec((d_in, d_out), dtype=dtype, fan_in_axes=(0,))}


def rmsnorm_specs(d: int, dtype: torch.dtype) -> dict:
    return {"scale": spec((d,), dtype=dtype, init="ones")}


def embed_specs(vocab: int, d: int, dtype: torch.dtype) -> dict:
    return {"embedding": spec((vocab, d), dtype=dtype, init="embed")}


def swiglu_specs(d: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {"gate": dense_specs(d, d_ff, dtype=dtype),
            "up": dense_specs(d, d_ff, dtype=dtype),
            "down": dense_specs(d_ff, d, dtype=dtype)}


# ---------------------------------------------------------------- apply ----

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


def rmsnorm(params: dict, x: torch.Tensor, eps: float,
            compute_dtype: torch.dtype) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(compute_dtype)


def embed_lookup(params: dict, ids: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table; out-of-range ids clamp (the JAX package's
    ``mode="clip"``), so a bad id never poisons the batch."""
    table = params["embedding"]
    ids = ids.clamp(0, table.shape[0] - 1)
    return table[ids].to(compute_dtype)


def embed_logits(params: dict, x: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Tied read-out: x @ E^T."""
    table = params["embedding"].to(compute_dtype)
    return x.to(compute_dtype) @ table.T


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s arithmetic op by op, x * (1 / (1 + exp(-x))), so
    bf16 rounds where the JAX package rounds (``F.silu`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(params: dict, x: torch.Tensor, compute_dtype: torch.dtype
           ) -> torch.Tensor:
    g = silu(dense(params["gate"], x, compute_dtype))
    u = dense(params["up"], x, compute_dtype)
    return dense(params["down"], g * u, compute_dtype)


def gelu_mlp(params: dict, x: torch.Tensor, compute_dtype: torch.dtype
             ) -> torch.Tensor:
    # jax.nn.gelu(approximate=True) is the tanh approximation
    h = F.gelu(dense(params["fc1"], x, compute_dtype), approximate="tanh")
    return dense(params["fc2"], h, compute_dtype)
