"""Grouped-query attention with RoPE: prefill, KV-cache decode, and the
bidirectional encoder attention of the ViT trunk.

Port of ``repro/models/attention.py`` (the sharding constraints are
ROADMAP item 14).  Weights keep the JAX layout: ``wq`` (d, H, Dh), ``wk`` /
``wv`` (d, Kv, Dh) or one fused ``wqkv`` (d, H + 2 Kv, Dh), and ``wo``
(H, Dh, d), no biases.  An int8-resident weight is ``{q, scale}``: int8
values and a float32 scale over the output axes ((H, Dh) for the
projections in, (d,) for ``wo``), dequantized in the compute dtype.  An
int8 KV cache holds int8 ``k`` / ``v`` and float32 ``k_scale`` /
``v_scale`` per position and KV head.

The causal ``attention`` and ``decode_attention`` always go through
:mod:`repro_torch.kernels.attention.ops`: with ``impl=None`` a CUDA tensor
launches the hand-written kernels (K6 in prefill, K7 in decode) and a CPU
tensor runs their plain versions; ``impl="torch"`` asks for the plain
versions on any device.  ``encoder_attention`` keeps the plain path by
default (``impl="xla"``), as the JAX package does (its detector pins it);
``impl="flash"`` takes K6, non-causal, and ``impl="torch"`` K6's plain
version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.param import spec


# ------------------------------------------------------------------ RoPE ----

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (half,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- specs ----

def _wspec(shape, dtype: torch.dtype, quant: bool,
           scale_axes_from: int = 1):
    """Weight spec; int8 + a float32 scale over ``shape[scale_axes_from:]``
    when quantized."""
    if quant:
        return {"q": spec(shape, dtype=torch.int8, init="zeros"),
                "scale": spec(shape[scale_axes_from:], dtype=torch.float32,
                              init="ones")}
    return spec(shape, dtype=dtype,
                fan_in_axes=tuple(range(scale_axes_from)))


def weight(p, compute_dtype: torch.dtype) -> torch.Tensor:
    """A (possibly int8-quantised) weight in the compute dtype; the
    dequantizing product is taken in the compute dtype, as the JAX package
    takes it."""
    if isinstance(p, dict):
        return p["q"].to(compute_dtype) * p["scale"].to(compute_dtype)
    return p.to(compute_dtype)


def gqa_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              dtype: torch.dtype, fused: bool = False,
              quant: bool = False) -> dict:
    wo = _wspec((n_heads, head_dim, d_model), dtype, quant,
                scale_axes_from=2)
    if fused:
        return {"wqkv": _wspec((d_model, n_heads + 2 * n_kv_heads, head_dim),
                               dtype, quant),
                "wo": wo}
    return {"wq": _wspec((d_model, n_heads, head_dim), dtype, quant),
            "wk": _wspec((d_model, n_kv_heads, head_dim), dtype, quant),
            "wv": _wspec((d_model, n_kv_heads, head_dim), dtype, quant),
            "wo": wo}


# ------------------------------------------------------------- attention ----

def _qkv(params: dict, x: torch.Tensor, n_kv_heads: int,
         compute_dtype: torch.dtype
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    def proj(w):
        return torch.einsum("bsd,dhk->bshk", x,
                            weight(w, compute_dtype)).contiguous()

    if "wqkv" in params:
        qkv = proj(params["wqkv"])
        n_heads = qkv.shape[2] - 2 * n_kv_heads
        return (qkv[:, :, :n_heads].contiguous(),
                qkv[:, :, n_heads:n_heads + n_kv_heads].contiguous(),
                qkv[:, :, n_heads + n_kv_heads:].contiguous())
    return proj(params["wq"]), proj(params["wk"]), proj(params["wv"])


def _out(params: dict, ctx: torch.Tensor,
         compute_dtype: torch.dtype) -> torch.Tensor:
    """ctx (B, S, H, Dh) -> (B, S, d)."""
    return torch.einsum("bshk,hkd->bsd", ctx,
                        weight(params["wo"], compute_dtype))


def attention(params: dict, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, rope_theta: float,
              compute_dtype: torch.dtype,
              positions: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Causal self-attention for prefill.  x: (B, S, d) -> (B, S, d); K6
    on a CUDA tensor (``impl`` as in the module docstring)."""
    _, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, n_kv_heads, compute_dtype)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    ctx = flash_ops.flash_attention(q, k, v, causal=True, impl=impl)
    return _out(params, ctx, compute_dtype)


def encoder_attention(params: dict, x: torch.Tensor, *,
                      compute_dtype: torch.dtype,
                      impl: str = "xla") -> torch.Tensor:
    """Bidirectional MHA (no RoPE) for the ViT and DiT encoders.  x: (B,
    S, d) -> (B, S, d); the head count is the weights' H (a fused
    ``wqkv`` holds 3 H).  ``impl="xla"`` (the default, and what the
    detector runs) is the plain path: scores taken in float32, a float32
    softmax, the context in the compute dtype;
    ``impl="flash"`` runs K6 non-causal (its plain version on the CPU);
    ``impl="torch"`` runs K6's plain version on any device, what a kernel
    run is held against."""
    w = params["wqkv"] if "wqkv" in params else params["wq"]
    n_heads = (w["q"] if isinstance(w, dict) else w).shape[1]
    if "wqkv" in params:
        n_heads //= 3
    q, k, v = _qkv(params, x, n_heads, compute_dtype)
    if impl in ("flash", "torch"):
        ctx = flash_ops.flash_attention(
            q, k, v, causal=False, impl=None if impl == "flash" else "torch")
        return _out(params, ctx, compute_dtype)
    if impl != "xla":
        raise ValueError(f"unknown encoder attention impl {impl!r}; choose "
                         f"from ['xla', 'flash', 'torch']")
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v)
    return _out(params, ctx, compute_dtype)


# ---------------------------------------------------------------- decode ----

def init_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
               dtype: torch.dtype, device: torch.device,
               quant_kv: bool = False) -> dict:
    shape = (batch, max_seq, n_kv_heads, head_dim)
    if quant_kv:
        sshape = (batch, max_seq, n_kv_heads)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 1, Kv, D) -> (int8 values, (B, 1, Kv) float32 scales)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention(params: dict, x: torch.Tensor, cache: dict, pos: int,
                     *, n_heads: int, n_kv_heads: int, rope_theta: float,
                     compute_dtype: torch.dtype, impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d); cache k / v: (B, Smax, Kv, Dh);
    ``pos``: the current position, a Python int.  Returns (out, cache).

    The new K/V row is written into the cache tensors in place, and the
    returned dict is ``cache`` itself: the JAX function returns a new cache
    (its ``"dus"`` update; the ``"masked"`` one serves a cache sharded on
    the sequence axis, which waits for ROADMAP item 14), so a decode loop
    here moves no cache bytes but the new row.  An int8 cache (``k_scale``
    in ``cache``) takes the new row quantized, values and scales written in
    place at ``pos``; the whole cache is then dequantized to the compute
    dtype for attention, as the JAX package does before its decode kernel.
    Attention is K7 on a CUDA tensor (``impl`` as in the module
    docstring).
    """
    if isinstance(pos, torch.Tensor):
        raise TypeError("decode_attention: pos must be a Python int (a "
                        "device scalar would sync the host every step)")
    b = x.shape[0]
    q, k_new, v_new = _qkv(params, x, n_kv_heads, compute_dtype)
    positions = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    if "k_scale" in cache:
        for name, new in (("k", k_new), ("v", v_new)):
            qv, scale = _quantize_kv(new)
            cache[name][:, pos] = qv[:, 0]
            cache[f"{name}_scale"][:, pos] = scale[:, 0]
        k, v = (cache[name].to(compute_dtype)
                * cache[f"{name}_scale"].to(compute_dtype)[..., None]
                for name in ("k", "v"))
    else:
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"].to(compute_dtype), cache["v"].to(compute_dtype)
    ctx = flash_ops.flash_decode(q, k, v, pos, impl=impl)
    return _out(params, ctx, compute_dtype), cache
