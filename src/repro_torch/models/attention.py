"""Grouped-query attention with RoPE: prefill, KV-cache decode, and the
bidirectional encoder attention of the ViT trunk.

Port of ``repro/models/attention.py``, with its logical constraints on
q, k, the output and the decode cache (``sharding.with_logical_constraint``:
they read the ambient mesh and rules, and return their input outside a
mesh).  Weights keep the JAX layout: ``wq`` (d, H, Dh), ``wk`` /
``wv`` (d, Kv, Dh) or one fused ``wqkv`` (d, H + 2 Kv, Dh), and ``wo``
(H, Dh, d), no biases (ViTDet's encoder attention adds q/k/v/o
biases and relative-position tables, :func:`encoder_attention`).  An
int8-resident weight is ``{q, scale}``: int8 values and a float32 scale
over the output axes ((H, Dh) for the projections in, (d,) for ``wo``),
dequantized in the compute dtype.  An int8 KV cache holds int8 ``k`` /
``v`` and float32 ``k_scale`` / ``v_scale`` per position and KV head.

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
from typing import Optional, Tuple, Union

import torch

from repro_torch.compat import shardingx
from repro_torch.config import CACHE_UPDATES
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.param import spec
from repro_torch.sharding import (is_dtensor, per_device,
                                  with_logical_constraint)


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

def _wspec(shape, axes, dtype: torch.dtype, quant: bool,
           scale_axes_from: int = 1):
    """Weight spec; int8 + a float32 scale over ``shape[scale_axes_from:]``
    when quantized."""
    if quant:
        return {"q": spec(shape, axes, dtype=torch.int8, init="zeros"),
                "scale": spec(shape[scale_axes_from:],
                              axes[scale_axes_from:], dtype=torch.float32,
                              init="ones")}
    return spec(shape, axes, dtype=dtype,
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
    wo = _wspec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
                dtype, quant, scale_axes_from=2)
    if fused:
        return {"wqkv": _wspec((d_model, n_heads + 2 * n_kv_heads, head_dim),
                               ("embed", "heads", "head_dim"), dtype, quant),
                "wo": wo}
    return {"wq": _wspec((d_model, n_heads, head_dim),
                         ("embed", "heads", "head_dim"), dtype, quant),
            "wk": _wspec((d_model, n_kv_heads, head_dim),
                         ("embed", "kv_heads", "head_dim"), dtype, quant),
            "wv": _wspec((d_model, n_kv_heads, head_dim),
                         ("embed", "kv_heads", "head_dim"), dtype, quant),
            "wo": wo}


# ------------------------------------------------------------- attention ----

def _qkv(params: dict, x: torch.Tensor, n_kv_heads: int,
         compute_dtype: torch.dtype
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    def proj(w):
        return _heads_proj(x, weight(w, compute_dtype)).contiguous()

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
    return _heads_out(ctx, weight(params["wo"], compute_dtype))


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
    q = with_logical_constraint(q, ("batch", "seq", "heads", "head_dim"))
    k = with_logical_constraint(k, ("batch", "seq", "kv_heads", "head_dim"))

    def core(q, k, v):
        kv = k.shape[2]                 # the local KV heads under a mesh
        if impl == "chunked":
            return _chunked_causal(q, k, v, kv)
        if impl == "xla":
            scores = _gqa_scores(q, k, kv)
            idx = torch.arange(s, device=q.device)
            causal = idx[:, None] >= idx[None, :]
            scores = torch.where(causal[None, None, None], scores, NEG_INF)
            return _gqa_ctx(torch.softmax(scores, dim=-1), v, compute_dtype)
        return flash_ops.flash_attention(q, k, v, causal=True, impl=impl)

    ctx = _per_head_group(core, q, k, v)
    return with_logical_constraint(_out(params, ctx, compute_dtype),
                                   ("batch", "seq", "embed"))


def rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """A decomposed relative-position table (2 size - 1, Dh) -> (size,
    size, Dh) whose row ``[i, j]`` is the entry of offset ``i - j``
    (ViTDet's ``get_rel_pos`` at equal query and key sizes; the tables
    are held at the grid they serve, so none is interpolated)."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} "
                         f"rows serves a grid of side "
                         f"{(rel_pos.shape[0] + 1) // 2}, not {size}")
    pos = torch.arange(size, device=rel_pos.device)
    return rel_pos[pos[:, None] - pos[None, :] + size - 1]


def _add_rel_pos(scores: torch.Tensor, q: torch.Tensor, params: dict,
                 grid: Tuple[int, int],
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """ViTDet's ``add_decomposed_rel_pos``: the float32 logits (B, H, S,
    S) of queries q (B, S, H, Dh) on a row-major (gh, gw) grid plus, in
    place, ``q . Rh[i_h - j_h]`` and ``q . Rw[i_w - j_w]`` with the
    unscaled q, each a product in the compute dtype."""
    b, s, h, d = q.shape
    gh, gw = grid
    rh = rel_pos_table(params["rel_pos_h"], gh).to(compute_dtype)
    rw = rel_pos_table(params["rel_pos_w"], gw).to(compute_dtype)
    rq = q.reshape(b, gh, gw, h, d)
    rel_h = torch.einsum("byxhd,ykd->bhyxk", rq, rh).to(torch.float32)
    rel_w = torch.einsum("byxhd,xkd->bhyxk", rq, rw).to(torch.float32)
    grid_scores = scores.view(b, h, gh, gw, gh, gw)
    grid_scores.add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
    return scores


def encoder_attention(params: dict, x: torch.Tensor, *,
                      compute_dtype: torch.dtype,
                      impl: str = "xla",
                      grid: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Bidirectional MHA (no RoPE) for the ViT and DiT encoders.  x: (B,
    S, d) -> (B, S, d); the head count is the weights' H (a fused
    ``wqkv`` holds 3 H).  ``impl="xla"`` (the default, and what the
    detector runs) is the plain path: scores taken in float32, a float32
    softmax, the context in the compute dtype;
    ``impl="flash"`` runs K6 non-causal (its plain version on the CPU);
    ``impl="torch"`` runs K6's plain version on any device, what a kernel
    run is held against.

    ViTDet's attention: biases ``bq`` / ``bk`` / ``bv`` (H, Dh) and
    ``bo`` (d,) in ``params`` are added to the projections; tables
    ``rel_pos_h`` / ``rel_pos_w`` add decomposed relative-position terms
    to the plain path's float32 logits (:func:`_add_rel_pos`), with
    ``grid`` the (rows, columns) the tokens lie on, row-major.  K6 takes
    no logit bias, so ``"flash"`` and ``"torch"`` refuse the tables."""
    w = params["wqkv"] if "wqkv" in params else params["wq"]
    n_heads = (w["q"] if isinstance(w, dict) else w).shape[1]
    if "wqkv" in params:
        n_heads //= 3
    rel = "rel_pos_h" in params
    if rel and impl in ("flash", "torch"):
        raise ValueError(f"encoder attention impl {impl!r} (K6) takes no "
                         f"relative-position logits; ViTDet's attention "
                         f"runs on the plain path (impl='xla')")
    if rel and grid is None:
        raise ValueError("relative positions need the token grid (grid=)")
    q, k, v = _qkv(params, x, n_heads, compute_dtype)
    if "bq" in params:
        q, k, v = (t + params[name].to(compute_dtype)
                   for t, name in ((q, "bq"), (k, "bk"), (v, "bv")))
    if impl in ("flash", "torch"):
        ctx = flash_ops.flash_attention(
            q, k, v, causal=False, impl=None if impl == "flash" else "torch")
        return _out(params, ctx, compute_dtype)
    if impl != "xla":
        raise ValueError(f"unknown encoder attention impl {impl!r}; choose "
                         f"from ['xla', 'flash', 'torch']")

    def core(q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(
            torch.float32) * scale
        if rel:
            scores = _add_rel_pos(scores, q, params, grid, compute_dtype)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(compute_dtype), v)

    ctx = _per_head_group(core, q, k, v)
    out = _out(params, ctx, compute_dtype)
    if "bo" in params:
        out = out + params["bo"].to(compute_dtype)
    return with_logical_constraint(out, ("batch", "seq", "embed"))


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


def cache_specs(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
                dtype: torch.dtype, quant_kv: bool = False) -> dict:
    """``meta`` cache stand-ins for the dry run (``jax.ShapeDtypeStruct``s
    in the JAX package)."""
    return init_cache(batch, max_seq, n_kv_heads, head_dim, dtype,
                      torch.device("meta"), quant_kv=quant_kv)


CACHE_AXES = ("decode_batch", "kv_seq", "kv_heads", "head_dim")
CACHE_SCALE_AXES = ("decode_batch", "kv_seq", "kv_heads")


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 1, Kv, D) -> (int8 values, (B, 1, Kv) float32 scales)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def resolve_cache_update(cache_update: str) -> str:
    """``"dus"`` or ``"masked"``: ``"auto"`` is ``"masked"`` when the
    ambient rules (``compat.shardingx.use_mesh``) shard the cache's
    sequence axis (``kv_seq``), as the JAX ``rules.get("kv_seq")``, and
    ``"dus"`` otherwise."""
    if cache_update not in CACHE_UPDATES:
        raise ValueError(f"cache_update {cache_update!r} is not one of "
                         f"{CACHE_UPDATES}")
    if cache_update != "auto":
        return cache_update
    rules = shardingx.get_rules()
    return "masked" if rules and rules.get("kv_seq") else "dus"


def decode_position(pos, device: torch.device) -> Union[int, torch.Tensor]:
    """``pos`` as the decode path takes it: a Python int, or a 0-d int32
    tensor on ``device`` (the JAX ``pos``, a Python int or a traced
    int32).  A tensor of another integer type is cast on the device; a
    DTensor ``pos`` (replicated, as the JAX plan's ``PartitionSpec()``)
    gives its whole value.  Nothing here reads a device value on the
    host."""
    if not isinstance(pos, torch.Tensor):
        return int(pos)
    if is_dtensor(pos):
        pos = pos.full_tensor()
    if (pos.dim() != 0 or pos.dtype == torch.bool
            or pos.is_floating_point() or pos.is_complex()):
        raise TypeError(f"decode: pos must be an int or a 0-d integer "
                        f"tensor, got {pos.dtype} {tuple(pos.shape)}")
    if pos.device != device:
        raise ValueError(f"decode: pos on {pos.device}, the step on "
                         f"{device}")
    return pos.to(torch.int32)


def decode_attention(params: dict, x: torch.Tensor, cache: dict,
                     pos: Union[int, torch.Tensor],
                     *, n_heads: int, n_kv_heads: int, rope_theta: float,
                     compute_dtype: torch.dtype, impl: Optional[str] = None,
                     cache_update: str = "auto"
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d); cache k / v: (B, Smax, Kv, Dh);
    ``pos``: the current position, a Python int or a 0-d integer tensor on
    x's device (:func:`decode_position`).  Returns (out, cache).

    ``cache_update`` (:func:`resolve_cache_update`) picks the write of the
    new K/V row.  ``"dus"`` writes it into the cache tensors in place and
    returns ``cache`` itself, so a decode loop moves no cache bytes but
    the row (the JAX ``dynamic_update_slice`` returns a new cache).
    ``"masked"`` is the JAX one-hot blend: ``torch.where`` of
    ``arange(Smax) == pos`` against the cache gives a new cache dict and
    leaves the input's tensors as they were; it reads and writes the whole
    cache.  On a DTensor cache both keep the cache's placements and move
    only the row, laid out as the cache with its one position replicated:
    each device writes or blends its own shard.  An int8 cache
    (``k_scale`` in ``cache``) takes the new row quantized, values and
    scales written the same way; the whole cache is then dequantized to the
    compute dtype for attention, as the JAX package does before its decode
    kernel.  The JAX ``"auto"`` blends every int8 cache; the port's blends
    one only where ``kv_seq`` is sharded, and writes it in place
    otherwise (one card).  Attention is K7 on a CUDA tensor (``impl`` as in
    the module docstring).

    A tensor ``pos`` is read on the device only (RoPE's positions, the
    row's index, the masks, K7), so one step captured in a CUDA graph
    serves every position.  Its ``"dus"`` write clamps it into [0, Smax),
    as XLA's ``dynamic_update_slice`` clamps its start (a host int outside
    the cache raises there).
    """
    pos = decode_position(pos, x.device)
    update = resolve_cache_update(cache_update)
    b = x.shape[0]
    q, k_new, v_new = _qkv(params, x, n_kv_heads, compute_dtype)
    positions = (pos.expand(b, 1) if isinstance(pos, torch.Tensor)
                 else torch.full((b, 1), pos, device=x.device))
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    quant_kv = "k_scale" in cache
    rows = {}
    for name, new in (("k", k_new), ("v", v_new)):
        if quant_kv:
            rows[name], rows[f"{name}_scale"] = _quantize_kv(new)
        else:
            rows[name] = new.to(cache[name].dtype)
    if update == "dus":
        for name, row in rows.items():
            _write_row(cache[name], row, pos)
        new_cache = cache
    else:
        new_cache = {name: _blend_row(cache[name], rows[name], pos)
                     for name in cache}
    k, v = (with_logical_constraint(new_cache[name], CACHE_AXES)
            for name in ("k", "v"))
    if update == "masked":
        new_cache.update(k=k, v=v)
    if quant_kv:
        k = k.to(compute_dtype) * new_cache["k_scale"].to(
            compute_dtype)[..., None]
        v = v.to(compute_dtype) * new_cache["v_scale"].to(
            compute_dtype)[..., None]
    else:
        k, v = k.to(compute_dtype), v.to(compute_dtype)
    if _seq_dims(k):
        ctx = _seq_sharded_decode(q, k, v, pos)
    else:
        ctx = _per_head_group(
            lambda q, k, v: flash_ops.flash_decode(q, k, v, pos, impl=impl),
            q, k, v)
    return _out(params, ctx, compute_dtype), new_cache


# ----------------------------------------------------- on a device mesh ----
#
# Inside ``api.run_abstract`` the activations are DTensors.  DTensor does
# not reshard through a view of a sharded dim the way GSPMD does, and the
# grouped-query reshapes and einsums of attention view the heads (and,
# inside ``torch.einsum``, the batch and sequence) dims.  So attention runs
# through ``local_map``: q, k and v are redistributed (explicitly, which the
# counters see) to a layout under which every device holds whole query
# groups — the batch kept where it was sharded, the heads sharded where
# they divide, everything else replicated — and the plain attention runs on
# each device's shard.  Outside a mesh these helpers call the plain
# function on the tensors themselves.


def _group_placements(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """Per mesh dim: ``Shard(0)`` where q is batch-sharded, ``Shard(2)``
    (heads) where q is sharded otherwise and both head counts divide,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = q.device_mesh.shape
    h_div, kv_div = q.shape[2], k.shape[2]
    out = []
    for size, pl in zip(sizes, q.placements):
        if pl == Shard(0):
            out.append(Shard(0))
        elif (not isinstance(pl, Replicate) and h_div % size == 0
              and kv_div % size == 0):
            h_div, kv_div = h_div // size, kv_div // size
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _per_head_group(fn, q, k, v):
    """``fn(q, k, v) -> ctx`` (B, S, H, D), per device on whole query
    groups when q is a DTensor (see above), else on the tensors."""
    if not is_dtensor(q):
        return fn(q, k, v)
    pl = _group_placements(q, k)
    return per_device(fn, pl, (pl, pl, pl), q.device_mesh)(q, k, v)


def _heads_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, Dh) -> (B, S, H, Dh).  On DTensors, per mesh
    dim: batch-sharded x stays so (w replicated); else heads-sharded w
    stays so (column parallel: x replicated, so a sequence-sharded x is
    all-gathered, as Megatron's sequence parallelism does); else a
    sequence-sharded x stays so; else both replicated (an FSDP-sharded w
    is all-gathered)."""
    if not is_dtensor(x):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Replicate, Shard
    xs, ws, os_ = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp == Shard(0):
            xs.append(Shard(0)), ws.append(Replicate()), os_.append(Shard(0))
        elif wp == Shard(1):
            xs.append(Replicate()), ws.append(Shard(1)), os_.append(Shard(2))
        elif xp == Shard(1):
            xs.append(Shard(1)), ws.append(Replicate()), os_.append(Shard(1))
        else:
            xs.append(Replicate()), ws.append(Replicate())
            os_.append(Replicate())
    return per_device(lambda a, b: torch.einsum("bsd,dhk->bshk", a, b),
                      os_, (xs, ws), x.device_mesh)(x, w)


def _heads_out(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ctx (B, S, H, Dh) @ wo (H, Dh, d) -> (B, S, d).  On DTensors, per
    mesh dim: batch and sequence shards of ctx stay; heads-sharded ctx
    meets heads-sharded wo (row parallel: a partial sum, reduced where the
    next constraint asks); else both replicated."""
    if not is_dtensor(ctx):
        return torch.einsum("bshk,hkd->bsd", ctx, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    cs, ws, os_ = [], [], []
    for cp, wp in zip(ctx.placements, w.placements):
        if cp in (Shard(0), Shard(1)):
            cs.append(cp), ws.append(Replicate()), os_.append(cp)
        elif cp == Shard(2) and w.shape[0] == ctx.shape[2]:
            cs.append(Shard(2)), ws.append(Shard(0)), os_.append(Partial())
        else:
            cs.append(Replicate()), ws.append(Replicate())
            os_.append(Replicate())
    return per_device(lambda a, b: torch.einsum("bshk,hkd->bsd", a, b),
                      os_, (cs, ws), ctx.device_mesh)(ctx, w)


def _seq_dims(cache: torch.Tensor) -> list:
    """The mesh dims a DTensor cache shards its sequence axis over."""
    if not is_dtensor(cache):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(cache.placements) if pl == Shard(1)]


def _seq_offset(cache: torch.Tensor) -> int:
    """The first cache position this device's shard holds (mesh order)."""
    mesh = cache.device_mesh
    local = cache.to_local().shape[1]
    off, span = 0, local
    for i in reversed(_seq_dims(cache)):
        off += mesh.get_local_rank(i) * span
        span *= mesh.shape[i]
    return off


def _write_row(cache: torch.Tensor, new: torch.Tensor,
               pos: Union[int, torch.Tensor]) -> None:
    """``cache[:, pos] = new[:, 0]`` in place; a tensor ``pos`` (clamped
    into the cache, as ``dynamic_update_slice`` clamps) through
    ``index_copy_``, which reads it on the device.  A DTensor cache takes
    the row on the device whose shard holds ``pos`` (the row laid out as
    the cache is, its one position replicated): each device writes its
    own shard, so nothing but the row moves; with a tensor ``pos`` every
    shard writes its clamped row back blended with ``where``, the new row
    only on the shard that holds ``pos``."""
    if not is_dtensor(cache):
        if isinstance(pos, torch.Tensor):
            at = pos.clamp(0, cache.shape[1] - 1).reshape(1).long()
            cache.index_copy_(1, at, new)
        else:
            cache[:, pos] = new[:, 0]
        return
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if pl == Shard(1) else pl
                 for pl in cache.placements)
    row = new.redistribute(cache.device_mesh, want).to_local()
    local = cache.to_local()
    off = _seq_offset(cache) if _seq_dims(cache) else 0
    if isinstance(pos, torch.Tensor):
        at = pos.clamp(0, cache.shape[1] - 1) - off
        mine = (at >= 0) & (at < local.shape[1])
        at = at.clamp(0, local.shape[1] - 1).reshape(1).long()
        local.index_copy_(1, at, torch.where(mine, row,
                                             local.index_select(1, at)))
        return
    at = pos - off
    if 0 <= at < local.shape[1]:
        local[:, at] = row[:, 0]


def _blend_row(cache: torch.Tensor, new: torch.Tensor,
               pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """A new tensor: ``cache`` with position ``pos`` (dim 1) replaced by
    ``new[:, 0]``, as a select of ``arange(Smax) == pos`` against the
    cache (the JAX masked update).  A DTensor cache keeps its placements:
    the row is laid out as :func:`_write_row` lays it out, and each device
    blends its own shard, so no cache bytes move between shards."""
    def blend(c, r, start):
        sel = torch.arange(start, start + c.shape[1], device=c.device) == pos
        return torch.where(sel.view((1, -1) + (1,) * (c.dim() - 2)), r, c)
    if not is_dtensor(cache):
        return blend(cache, new, 0)
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if pl == Shard(1) else pl
                 for pl in cache.placements)
    start = _seq_offset(cache) if _seq_dims(cache) else 0
    return per_device(lambda c, r: blend(c, r, start), cache.placements,
                      (cache.placements, want), cache.device_mesh)(cache, new)


def _seq_sharded_decode(q, k, v, pos: Union[int, torch.Tensor]):
    """Decode attention over a cache whose sequence axis is sharded (the
    sequence-parallel overlay): each device scores its own positions, the
    softmax's max and sum reduce across the shards (DTensor's reductions:
    two small all-reduces), and each device's share of the context is
    summed (a third).  q (B, 1, H, D) is replicated over the sequence's
    mesh dims (an all-gather of one token's heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    seq = set(_seq_dims(k))
    batch = [pl == Shard(0) for pl in k.placements]
    kv_pl = tuple(Shard(1) if i in seq else Shard(0) if batch[i]
                  else Replicate() for i in range(len(batch)))
    q_pl = tuple(Shard(0) if batch[i] else Replicate()
                 for i in range(len(batch)))
    s_pl = tuple(Shard(4) if i in seq else Shard(0) if batch[i]
                 else Replicate() for i in range(len(batch)))
    c_pl = tuple(Partial() if i in seq else Shard(0) if batch[i]
                 else Replicate() for i in range(len(batch)))
    k = k.redistribute(k.device_mesh, kv_pl)
    v = v.redistribute(v.device_mesh, kv_pl)
    off = _seq_offset(k)

    def scores_fn(q, k):
        sc = _gqa_scores(q, k, k.shape[2])               # (B,Kv,G,1,S_l)
        cols = off + torch.arange(k.shape[1], device=q.device)
        return torch.where((cols <= pos)[None, None, None, None], sc,
                           NEG_INF)

    def ctx_fn(p, v):
        return _gqa_ctx(p, v, v.dtype)

    mesh = k.device_mesh
    scores = per_device(scores_fn, s_pl, (q_pl, kv_pl), mesh)(q, k)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return per_device(ctx_fn, c_pl, (s_pl, kv_pl), mesh)(p.to(v.dtype), v)
