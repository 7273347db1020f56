"""Plain PyTorch oracle for the flash attention kernels (GQA + segments).

Line-for-line port of ``repro/kernels/attention/ref.py``: scores in the
input dtype (so bf16 inputs give bf16-rounded scores, as the JAX einsum
does), taken to float32 and divided by sqrt(D), masked with the finite
``NEG_INF``, a float32 softmax, and the probabilities rounded to the input
dtype before the context product.  This is what a CPU tensor runs and what
the CUDA kernels (K6, K7) are held against on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Kv, D) with H % Kv == 0.

    segment_ids: optional (B, S) int32 — packed-sequence block-diagonal
    masking: positions in different segments never attend to each other.
    Assumes Sq == Skv when given.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    skv = k.shape[1]
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = torch.where(seg[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return ctx.reshape(b, sq, h, d)


def decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, Smax, Kv, D); attend to positions <= pos
    (a host int or a 0-d integer tensor)."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    valid = (torch.arange(k.shape[1], device=q.device)
             <= pos)[None, None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return ctx.reshape(b, 1, h, d)
