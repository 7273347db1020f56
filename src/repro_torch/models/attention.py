"""Bidirectional multi-head attention for the ViT encoder.

Port of ``encoder_attention`` from ``repro/models/attention.py`` (the
``"xla"`` path the detector runs): projections, scores taken in float32,
float32 softmax, context in the compute dtype.  Weights keep the JAX
layout: ``wq/wk/wv`` (d, H, Dh), ``wo`` (H, Dh, d), no biases.
"""
from __future__ import annotations

import math

import torch


def encoder_attention(params: dict, x: torch.Tensor, *,
                      compute_dtype: torch.dtype) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); the head count is the weights' H."""
    def proj(w):
        return torch.einsum("bsd,dhk->bshk", x, w.to(compute_dtype))

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v)
    return torch.einsum("bshk,hkd->bsd", ctx,
                        params["wo"].to(compute_dtype))
