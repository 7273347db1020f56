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
JAX package's are ``jnp.einsum``s outside any Pallas kernel.  The token
groups, the experts' inputs and their outputs take the JAX package's
logical constraints (``sharding.with_logical_constraint``), which read the
ambient rules: ``moe_block`` takes no ``rules`` argument, and outside a
mesh the constraints return their inputs.

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
from repro_torch.sharding import (gather_dims, gather_grad_dims, is_dtensor,
                                  per_device, replicated,
                                  with_logical_constraint)


def _espec(shape, axes, dtype: torch.dtype, quant: bool):
    """An expert kernel (E, in, out); its fan-in is the middle axis (the
    reduce axis of its int8 scales too)."""
    if quant:
        return {"q": spec(shape, axes, dtype=torch.int8, init="zeros",
                          fan_in_axes=(1,)),
                "scale": spec((shape[0], shape[2]), (axes[0], axes[2]),
                              dtype=torch.float32, init="ones")}
    return spec(shape, axes, dtype=dtype, fan_in_axes=(1,))


def _eweight(p, compute_dtype: torch.dtype) -> torch.Tensor:
    if isinstance(p, dict) and "q" in p:
        return (p["q"].to(compute_dtype)
                * p["scale"].to(compute_dtype)[:, None, :])
    return p.to(compute_dtype)


def moe_specs(d_model: int, cfg: MoEConfig, dtype: torch.dtype,
              quant: bool = False) -> dict:
    ff = cfg.d_ff_expert or d_model * 4
    p = {
        "router": spec((d_model, cfg.n_experts), ("embed", "expert"),
                       dtype=torch.float32, fan_in_axes=(0,)),
        "wg": _espec((cfg.n_experts, d_model, ff),
                     ("expert", "embed", "expert_mlp"), dtype, quant),
        "wu": _espec((cfg.n_experts, d_model, ff),
                     ("expert", "embed", "expert_mlp"), dtype, quant),
        "wd": _espec((cfg.n_experts, ff, d_model),
                     ("expert", "expert_mlp", "embed"), dtype, quant),
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


def _router(xt, router):
    return torch.einsum("gsd,de->gse", xt, router)


def _dispatch(dispatch, xt):
    return torch.einsum("gsec,gsd->gecd", dispatch, xt)


def _experts(expert_in, wg, wu, wd):
    h = layers.silu(torch.einsum("gecd,edf->gecf", expert_in, wg)) \
        * torch.einsum("gecd,edf->gecf", expert_in, wu)
    return torch.einsum("gecf,efd->gecd", h, wd)


def _combine(combine, expert_out):
    return torch.einsum("gsec,gecd->gsd", combine, expert_out)


# Per mesh dim, from the placement of the first (routing) or second
# (expert-side) operand: the placement of each operand and of the output.
# On DTensors the block's einsums run per device through ``local_map``
# (DTensor's einsum reshapes through sharded dims, and its backward views
# a permuted shard): token groups stay where they are sharded, experts
# where they are, and a weight sharded otherwise (FSDP's "embed") is
# gathered, as GSPMD gathers it.
def _ROUTER(pls):
    from torch.distributed.tensor import Replicate, Shard
    if pls[0] == Shard(0):
        return Shard(0), Replicate(), Shard(0)
    return Replicate(), Replicate(), Replicate()


def _BY_GROUP(pls):
    from torch.distributed.tensor import Replicate, Shard
    if Shard(0) in pls:
        return Shard(0), Shard(0), Shard(0)
    return Replicate(), Replicate(), Replicate()


def _EXPERTS(pls):
    from torch.distributed.tensor import Replicate, Shard
    if pls[0] == Shard(0):
        return Shard(0), Replicate(), Replicate(), Replicate(), Shard(0)
    if pls[0] == Shard(1):
        return Shard(1), Shard(0), Shard(0), Shard(0), Shard(1)
    return (Replicate(),) * 5


def _COMBINE(pls):
    from torch.distributed.tensor import Partial, Replicate, Shard
    if pls[1] == Shard(0):
        return Shard(0), Shard(0), Shard(0)
    if pls[1] == Shard(1):
        return Shard(2), Shard(1), Partial()
    return Replicate(), Replicate(), Replicate()


def _sharded(fn, rule, *xs):
    """``fn(*xs)``; on DTensors per device, each mesh dim laid out by
    ``rule`` (see above)."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    per_dim = [rule(tuple(_placement(x, i) for x in xs))
               for i in range(xs[0].device_mesh.ndim)]
    ins = tuple(tuple(p[j] for p in per_dim) for j in range(len(xs)))
    return per_device(fn, [p[-1] for p in per_dim], ins,
                      xs[0].device_mesh)(*xs)


def _placement(x, i):
    from torch.distributed.tensor import Replicate
    return x.placements[i] if is_dtensor(x) else Replicate()


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

    # the token groups cut across the sequence: a sequence-sharded x (the
    # activation-sequence overlay) is gathered before DTensor reshapes it
    xt = gather_dims(x, (1,)).reshape(n_groups, gs, d)
    xt = with_logical_constraint(xt, ("expert_group", None, "embed"))
    logits = _sharded(_router, _ROUTER, xt.to(torch.float32),
                      params["router"].to(torch.float32))
    gates = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _top_k_dispatch(gates, cfg, cap)
    # the scalar load-balance loss whole on every device before it joins
    # the model's loss (DTensor's backward cannot take a pending-sum scalar)
    aux = replicated(aux)
    dispatch = dispatch.to(compute_dtype)
    combine = combine.to(compute_dtype)

    # dispatch: (G,S,E,C) x (G,S,d) -> (G,E,C,d)
    expert_in = _sharded(_dispatch, _BY_GROUP, dispatch,
                         xt.to(compute_dtype))
    expert_in = with_logical_constraint(
        expert_in, ("expert_group", "expert", "capacity", "embed"))

    expert_out = _sharded(
        _experts, _EXPERTS, expert_in, _eweight(params["wg"], compute_dtype),
        _eweight(params["wu"], compute_dtype),
        _eweight(params["wd"], compute_dtype))
    expert_out = with_logical_constraint(
        expert_out, ("expert_group", "expert", "capacity", "embed"))

    # combine: (G,S,E,C) x (G,E,C,d) -> (G,S,d)
    out = _sharded(_combine, _COMBINE, combine, expert_out)
    # the next layer may shard the sequence: its gradient is gathered
    # before the backward pass views it back into token groups
    out = gather_grad_dims(out.reshape(B, S, d), (1,))

    if cfg.n_shared:
        out = out + layers.swiglu(params["shared"], x, compute_dtype)
    return out, aux
