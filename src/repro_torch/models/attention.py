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

``decode_attention`` always goes through
:mod:`repro_torch.kernels.attention.ops`, and so does the causal
``attention`` unless it is asked for one of the JAX package's training
paths: with ``impl=None`` a CUDA tensor launches the hand-written kernels
(K6 in prefill, K7 in decode) and a CPU tensor runs their plain versions;
``impl="torch"`` asks for the plain versions on any device.  ``attention``
also takes ``impl="xla"`` (plain scores, masked, a float32 softmax: the
JAX package's default) and ``impl="chunked"`` (online softmax over KV
chunks, so the S x S scores never exist at once): the training step's
paths, which launch no kernel and carry gradients.
``encoder_attention`` keeps the plain path by default (``impl="xla"``),
as the JAX package does (its detector pins it); ``impl="flash"`` takes
K6, non-causal, and ``impl="torch"`` K6's plain version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention.ref import NEG_INF
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


def _inv_sqrt(d: int, device) -> torch.Tensor:
    """1 / sqrt(D) in float32, as the JAX package takes it."""
    return 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                         device=device))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                n_kv_heads: int) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Skv, Kv, D) -> float32 scores (B, Kv, G, Sq,
    Skv), scaled by 1 / sqrt(D)."""
    b, sq, h, d = q.shape
    qg = q.reshape(b, sq, n_kv_heads, h // n_kv_heads, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    return scores * _inv_sqrt(d, q.device)


def _gqa_ctx(probs: torch.Tensor, v: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """probs (B, Kv, G, Sq, Skv), v (B, Skv, Kv, D) -> ctx (B, Sq, H, D)."""
    b, kv, g, sq, _ = probs.shape
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(compute_dtype), v)
    return ctx.reshape(b, sq, kv * g, v.shape[-1])


def _chunk_size(s: int) -> int:
    """The chunked path's tile: at most 8 chunks a axis, at least 2048
    positions, a divisor of ``s`` (the JAX package's ``_chunk_size``).  A
    sequence of at most 2048 is one chunk: the reference's search for a
    divisor from 2048 up never ends below 2048 (its plans take
    ``"chunked"`` only from 2048)."""
    if s <= 2048:
        return s
    c = max(2048, s // 8)
    while s % c:
        c += 1
    return min(c, s)


def _chunked_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_kv_heads: int) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks, the JAX package's
    ``_chunked_causal``: per query chunk a running max ``m``, sum ``l``
    and float32 accumulator over the KV chunks up to its end.  q (B, S, H,
    D); k, v (B, S, Kv, D) -> ctx (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    g = h // n_kv_heads
    c = _chunk_size(s)
    scale = _inv_sqrt(d, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = []
    for qs in range(0, s, c):
        qg = q[:, qs:qs + c].reshape(b, c, n_kv_heads, g, d)
        m = torch.full((b, n_kv_heads, g, c), NEG_INF, **f32)
        l = torch.zeros((b, n_kv_heads, g, c), **f32)
        acc = torch.zeros((b, c, n_kv_heads, g, d), **f32)
        rows = qs + torch.arange(c, device=q.device)[:, None]
        for ks in range(0, qs + c, c):
            ke = min(ks + c, s)
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              k[:, ks:ke]).to(torch.float32) * scale
            cols = ks + torch.arange(ke - ks, device=q.device)[None, :]
            sc = torch.where((rows >= cols)[None, None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p.to(q.dtype),
                v[:, ks:ke]).to(torch.float32)
            m = m_new
        ctx = acc / l.permute(0, 3, 1, 2)[..., None]
        out.append(ctx.reshape(b, c, h, d).to(q.dtype))
    return torch.cat(out, dim=1)


def attention(params: dict, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, rope_theta: float,
              compute_dtype: torch.dtype,
              positions: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Causal self-attention for prefill and training.  x: (B, S, d) ->
    (B, S, d); K6 on a CUDA tensor, or the ``"xla"`` / ``"chunked"``
    paths (``impl`` as in the module docstring)."""
    _, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, n_kv_heads, compute_dtype)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if impl == "chunked":
        ctx = _chunked_causal(q, k, v, n_kv_heads)
    elif impl == "xla":
        scores = _gqa_scores(q, k, n_kv_heads)
        idx = torch.arange(s, device=x.device)
        causal = idx[:, None] >= idx[None, :]
        scores = torch.where(causal[None, None, None], scores, NEG_INF)
        ctx = _gqa_ctx(torch.softmax(scores, dim=-1), v, compute_dtype)
    else:
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
