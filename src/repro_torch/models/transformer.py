"""Decoder-only LM (dense or MoE): the training loss, prefill and KV-cache
decode.

Port of ``repro/models/transformer.py``:

  param_specs(cfg)                           -> ParamSpec tree
  init_params(cfg, generator, device)        -> parameters
  convert_params(tree, cfg, device)          -> the JAX package's parameters
  forward(cfg, params, tokens)               -> (hidden (B, S, d), aux)
  lm_loss(cfg, params, batch)                -> scalar float32 loss
  prefill(cfg, params, tokens)               -> (last logits, hidden)
  init_cache(cfg, batch, max_seq, device)    -> KV cache
  decode_step(cfg, params, tokens, cache, pos) -> (logits (B, 1, V), cache)
  cache_axes(cfg)                            -> the cache's logical axes

Parameters and the cache take the JAX package's unscanned form, one dict
per layer under ``"layer_{i}"`` (the port runs layers in a Python loop, not
``lax.scan``):

    {"embed": {"embedding": (V, d)},
     "layers": {"layer_0": {"ln_attn": {"scale"}, "attn": {wq, wk, wv, wo}
                            or {wqkv, wo}, "ln_mlp": {"scale"},
                            "mlp": {"gate", "up", "down"}}, ...},
     "ln_f": {"scale"}, "lm_head": {"kernel": (d, V)}}

An MoE config (``cfg.moe``) holds ``"moe": {"router", "wg", "wu", "wd"[,
"shared"]}`` in place of ``"mlp"`` (``moe.moe_specs``), and ``forward``
returns the layers' summed load-balancing loss.

With ``quant_weights`` the layer and ``lm_head`` kernels are int8
(``{q, scale}`` / ``{kernel_q, kernel_scale}``, from
``quantize.quantize_params``); with ``quant_kv`` the cache is int8 with
float32 scales.

Every layer's attention goes through K6 in prefill and K7 in decode on a
CUDA tensor (``impl=None``); ``impl="torch"`` runs their plain versions, and
a CPU tensor always does.  ``lm_loss`` takes the JAX package's training
paths, ``impl="xla"`` (its default) or ``"chunked"``, which launch no
kernel; with ``cfg.remat`` each layer is recomputed in the backward pass
(``models/remat.py``, ``cfg.remat_policy``).  The activations take the
JAX package's logical constraints, which read the ambient mesh and rules
(``sharding.with_logical_constraint``; no-ops outside a mesh).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import HardwareConfig, TransformerConfig, dtype_of
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, remat
from repro_torch.param import convert_like, leaves, map_tree
from repro_torch.param import init_params as _init_tree
from repro_torch.sharding import with_logical_constraint

LOSS_CHUNK = 512

# ----------------------------------------------------------------- specs ----

def _layer_specs(cfg: TransformerConfig, dtype: torch.dtype) -> dict:
    quant = cfg.quant_weights
    p = {
        "ln_attn": layers.rmsnorm_specs(cfg.d_model, dtype),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dtype, fused=cfg.fused_qkv,
                               quant=quant),
        "ln_mlp": layers.rmsnorm_specs(cfg.d_model, dtype),
    }
    if cfg.moe is not None:
        p["moe"] = moe.moe_specs(cfg.d_model, cfg.moe, dtype, quant=quant)
    else:
        p["mlp"] = layers.swiglu_specs(cfg.d_model, cfg.d_ff, dtype,
                                       quant=quant)
    return p


def param_specs(cfg: TransformerConfig) -> dict:
    dtype = dtype_of(cfg.param_dtype)
    p = {
        "embed": layers.embed_specs(cfg.vocab, cfg.d_model, dtype),
        "layers": {f"layer_{i}": _layer_specs(cfg, dtype)
                   for i in range(cfg.n_layers)},
        "ln_f": layers.rmsnorm_specs(cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_specs(cfg.d_model, cfg.vocab,
                                          in_axis="embed", out_axis="vocab",
                                          dtype=dtype,
                                          quant=cfg.quant_weights)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the JAX package's init rules, drawn from
    ``generator`` on ``device`` (a CUDA generator draws them on the card).
    As in the JAX package, the int8 leaves of a ``quant_weights`` config
    are zeros: quantize a floating-point tree instead
    (``quantize.quantize_params``).

    A config whose parameters exceed one card's memory
    (``HardwareConfig.hbm_bytes``: ``mistral-large-123b``, 246 GB in bf16)
    raises before anything is allocated: such a model is planned on the
    meta device (``api.plan_cell``), and running it sharded over cards is
    ROADMAP item 17 (the second half of item 14)."""
    specs = param_specs(cfg)
    nbytes = sum(math.prod(s.shape) * s.dtype.itemsize
                 for s in leaves(specs))
    if nbytes > HardwareConfig.hbm_bytes:
        raise NotImplementedError(
            f"{cfg.name}: {nbytes / 1e9:.1f} GB of parameters do not fit "
            f"one {HardwareConfig.hbm_bytes / 2**30:.0f} GiB card; running "
            f"it sharded over cards is ROADMAP item 17 (the second half of "
            f"item 14)")
    return _init_tree(specs, generator, device)


def convert_params(tree: dict, cfg: TransformerConfig,
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's LM parameters (nested dicts of arrays, e.g. via
    ``np.asarray``) -> the port's tree on ``device``.  A scanned tree
    (``scan_layers=True``: every leaf under ``"layers"`` has a leading
    ``n_layers`` axis) is unstacked into ``layer_{i}`` dicts; an unscanned
    one is taken as it is.  Leaves are cast to ``cfg.param_dtype``, but for
    the int8-quantised weights of a ``quant_weights`` tree (``{q, scale}``,
    ``{kernel_q, kernel_scale}``), which keep int8 values and float32
    scales. ``dtype``, when given, is every leaf's dtype instead (an
    optimizer state's float32 moments, which have the parameters' tree)."""
    device = resolve_device(device)
    out = dict(tree)
    stacked = out["layers"]
    if "layer_0" not in stacked:
        out["layers"] = {f"layer_{i}": map_tree(
            lambda a, i=i: np.asarray(a)[i], stacked)
            for i in range(cfg.n_layers)}
    return convert_like(out, param_specs(cfg), device, dtype)


# --------------------------------------------------------------- forward ----

def _mlp(cfg: TransformerConfig, lp: dict, h: torch.Tensor,
         cdt: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP (SwiGLU, or the MoE block) and its aux loss (None
    for SwiGLU, so a dense layer launches nothing for it)."""
    if cfg.moe is not None:
        return moe.moe_block(lp["moe"], h, cfg.moe, compute_dtype=cdt)
    return layers.swiglu(lp["mlp"], h, cdt), None


def _layer(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
           positions: Optional[torch.Tensor], impl: Optional[str]
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    cdt = dtype_of(cfg.compute_dtype)
    h = layers.rmsnorm(lp["ln_attn"], x, cfg.norm_eps, cdt)
    h = attn.attention(lp["attn"], h, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
                       compute_dtype=cdt, positions=positions, impl=impl)
    x = x + h
    h = layers.rmsnorm(lp["ln_mlp"], x, cfg.norm_eps, cdt)
    h, aux = _mlp(cfg, lp, h, cdt)
    return x + h, aux


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (hidden (B, S, d) after the final norm, aux).
    ``aux`` is the MoE load-balancing loss summed over the layers (0 for a
    dense model), as the JAX function returns it."""
    cdt = dtype_of(cfg.compute_dtype)
    x = layers.embed_lookup(params["embed"], tokens, cdt)
    x = with_logical_constraint(x, ("batch", "seq", "embed"))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = remat.run(_layer, cfg, params["layers"][f"layer_{i}"], x,
                           positions, impl, remat=cfg.remat,
                           policy=cfg.remat_policy)
        if aux is not None:
            aux_total = aux_total + aux
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps, cdt)
    return x, aux_total


def logits(cfg: TransformerConfig, params: dict,
           h: torch.Tensor) -> torch.Tensor:
    """The read-out: ``lm_head``, or the tied embedding."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return layers.embed_logits(params["embed"], h, cdt)
    return layers.dense(params["lm_head"], h, cdt)


def lm_loss(cfg: TransformerConfig, params: dict, batch: dict, *,
            aux_weight: float = 0.01, impl: str = "xla") -> torch.Tensor:
    """batch: {tokens (B, S), labels (B, S)} -> the float32 mean next-token
    NLL (``layers.chunked_softmax_xent`` over ``LOSS_CHUNK`` positions)
    plus ``aux_weight`` x the MoE load-balancing loss."""
    h, aux = forward(cfg, params, batch["tokens"], impl=impl)
    nll = layers.chunked_softmax_xent(
        lambda hc: logits(cfg, params, hc), h, batch["labels"], LOSS_CHUNK)
    return nll + aux_weight * aux


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, *,
            impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence prefill: (last-position logits (B, 1, V), hidden
    (B, S, d))."""
    h, _ = forward(cfg, params, tokens, impl=impl)
    return logits(cfg, params, h[:, -1:, :]), h


# ---------------------------------------------------------------- decode ----

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> dict:
    """A zeroed KV cache, ``{"layer_{i}": {"k", "v"}}`` of (batch, max_seq,
    n_kv_heads, head_dim) in the compute dtype; with ``cfg.quant_kv``
    int8 ``k`` / ``v`` and float32 ``k_scale`` / ``v_scale`` of (batch,
    max_seq, n_kv_heads).  ``device="meta"`` gives the dry run's abstract
    cache (``attention.cache_specs``), which allocates nothing."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    return {f"layer_{i}": attn.init_cache(batch, max_seq, cfg.n_kv_heads,
                                          cfg.head_dim, dtype, device,
                                          quant_kv=cfg.quant_kv)
            for i in range(cfg.n_layers)}


def cache_axes(cfg: TransformerConfig) -> dict:
    """The logical axes of :func:`init_cache`'s tree, leaf for leaf."""
    one = {"k": attn.CACHE_AXES, "v": attn.CACHE_AXES}
    if cfg.quant_kv:
        one["k_scale"] = attn.CACHE_SCALE_AXES
        one["v_scale"] = attn.CACHE_SCALE_AXES
    return {f"layer_{i}": dict(one) for i in range(cfg.n_layers)}


def decode_step(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                cache: dict, pos: int, *, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  ``pos``: a Python int.
    The cache is updated in place and returned (see
    ``attention.decode_attention``)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = layers.embed_lookup(params["embed"], tokens, cdt)
    x = with_logical_constraint(x, ("decode_batch", None, "embed"))
    for i in range(cfg.n_layers):
        lp = params["layers"][f"layer_{i}"]
        h = layers.rmsnorm(lp["ln_attn"], x, cfg.norm_eps, cdt)
        h, _ = attn.decode_attention(
            lp["attn"], h, cache[f"layer_{i}"], pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            compute_dtype=cdt, impl=impl)
        x = x + h
        h = layers.rmsnorm(lp["ln_mlp"], x, cfg.norm_eps, cdt)
        x = x + _mlp(cfg, lp, h, cdt)[0]
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps, cdt)
    return logits(cfg, params, x), cache
