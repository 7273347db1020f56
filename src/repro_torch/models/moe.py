"""Mixture-of-Experts block: GShard-style grouped top-k dispatch.

Port of ``repro/models/moe.py``.  Tokens are reshaped into groups of
``group_size``; per group a capacity-bounded one-hot dispatch tensor routes
tokens to experts through dense einsums.  Top-k routing builds the dispatch
mask with k unrolled argmax rounds; a float32 cumsum gives each token its
slot in its expert's buffer, tokens past the capacity drop (standard GShard
behaviour), and the combine weights are normalised over the kept gates.

Shared experts (DeepSeekMoE) are a dense SwiGLU over all tokens, added to
the routed output.  The router runs in float32 whatever the compute dtype.
The expert products are plain batched products (cuBLAS on the card), as the
JAX package's are ``jnp.einsum``s outside any Pallas kernel.  The port has
no sharding rules (ROADMAP item 14), so ``moe_block`` takes no ``rules``.

An int8-resident expert weight (``quant_weights``) is ``{q, scale}``: int8
(E, in, out) values with one float32 scale per expert and output channel,
(E, out), dequantized in the compute dtype before its product.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.config import MoEConfig
from repro_torch.models import layers
from repro_torch.param import spec


def _espec(shape, dtype: torch.dtype, quant: bool):
    """An expert kernel (E, in, out); its fan-in is the middle axis (the
    reduce axis of its int8 scales too)."""
    if quant:
        return {"q": spec(shape, dtype=torch.int8, init="zeros",
                          fan_in_axes=(1,)),
                "scale": spec((shape[0], shape[2]), dtype=torch.float32,
                              init="ones")}
    return spec(shape, dtype=dtype, fan_in_axes=(1,))


def _eweight(p, compute_dtype: torch.dtype) -> torch.Tensor:
    if isinstance(p, dict) and "q" in p:
        return (p["q"].to(compute_dtype)
                * p["scale"].to(compute_dtype)[:, None, :])
    return p.to(compute_dtype)


def moe_specs(d_model: int, cfg: MoEConfig, dtype: torch.dtype,
              quant: bool = False) -> dict:
    ff = cfg.d_ff_expert or d_model * 4
    p = {
        "router": spec((d_model, cfg.n_experts), dtype=torch.float32,
                       fan_in_axes=(0,)),
        "wg": _espec((cfg.n_experts, d_model, ff), dtype, quant),
        "wu": _espec((cfg.n_experts, d_model, ff), dtype, quant),
        "wd": _espec((cfg.n_experts, ff, d_model), dtype, quant),
    }
    if cfg.n_shared:
        p["shared"] = layers.swiglu_specs(d_model, cfg.n_shared * ff, dtype,
                                          quant=quant)
    return p


def capacity(group_size: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(group_size * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, 1)


def _top_k_dispatch(gates: torch.Tensor, cfg: MoEConfig, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates: (G, S, E) float32 softmax router probabilities.

    Returns (dispatch, combine, aux_loss):
      dispatch: (G, S, E, C) 0/1 routing tensor
      combine:  (G, S, E, C) gate-weighted routing tensor
      aux_loss: load-balancing loss (scalar, float32)
    """
    G, S, E = gates.shape
    f32 = dict(dtype=torch.float32, device=gates.device)
    remaining = gates
    counts = torch.zeros((G, E), **f32)
    dispatch = torch.zeros((G, S, E, cap), **f32)
    gate_sum = torch.zeros((G, S), **f32)
    combine = torch.zeros((G, S, E, cap), **f32)
    experts = torch.arange(E, device=gates.device)
    slots = torch.arange(cap, device=gates.device)

    for _ in range(cfg.top_k):
        idx = torch.argmax(remaining, dim=-1)                    # (G,S)
        onehot = (idx[..., None] == experts).to(torch.float32)   # (G,S,E)
        gate_i = torch.sum(remaining * onehot, dim=-1)           # (G,S)
        remaining = remaining * (1.0 - onehot)
        # position of each token within its chosen expert's buffer
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        counts = counts + torch.sum(onehot, dim=1)
        pos_i = torch.sum(pos * onehot, dim=-1)                  # (G,S)
        keep = (pos_i < cap).to(torch.float32)               # capacity drop
        # jax.nn.one_hot: a slot past the capacity is an all-zero row
        slot = (pos_i.to(torch.int32)[..., None] == slots).to(torch.float32)
        d_i = onehot[..., None] * slot[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + d_i
        combine = combine + gate_i[..., None, None] * d_i
        gate_sum = gate_sum + gate_i * keep

    # normalize combine weights over the kept top-k gates
    combine = combine / torch.clamp(gate_sum, min=1e-9)[..., None, None]

    # Switch-style load-balance aux loss: E * sum_e f_e * p_e
    frac_tokens = torch.mean(torch.sum(dispatch, dim=-1), dim=1)  # (G,E) f_e
    frac_probs = torch.mean(gates, dim=1)                         # (G,E) p_e
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return dispatch, combine, aux


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
              compute_dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss)."""
    B, S, d = x.shape
    tokens = B * S
    gs = min(cfg.group_size, tokens)
    n_groups = tokens // gs
    assert tokens % gs == 0, (tokens, gs)
    cap = capacity(gs, cfg)

    xt = x.reshape(n_groups, gs, d)
    logits = torch.einsum("gsd,de->gse", xt.to(torch.float32),
                          params["router"].to(torch.float32))
    gates = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _top_k_dispatch(gates, cfg, cap)
    dispatch = dispatch.to(compute_dtype)
    combine = combine.to(compute_dtype)

    # dispatch: (G,S,E,C) x (G,S,d) -> (G,E,C,d)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch,
                             xt.to(compute_dtype))

    wg = _eweight(params["wg"], compute_dtype)
    wu = _eweight(params["wu"], compute_dtype)
    wd = _eweight(params["wd"], compute_dtype)
    h = layers.silu(torch.einsum("gecd,edf->gecf", expert_in, wg)) \
        * torch.einsum("gecd,edf->gecf", expert_in, wu)
    expert_out = torch.einsum("gecf,efd->gecd", h, wd)

    # combine: (G,S,E,C) x (G,E,C,d) -> (G,S,d)
    out = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    out = out.reshape(B, S, d)

    if cfg.n_shared:
        out = out + layers.swiglu(params["shared"], x, compute_dtype)
    return out, aux
