"""Shared primitive layers: dense, norms, embeddings, MLPs.

Port of the parts of ``repro/models/layers.py`` the detector, the ViT /
DiT models and the decoder-only LM run.  Functions take plain dicts of
tensors laid out as in the JAX package (dense kernels are (d_in,
d_out)); an int8-resident dense
holds ``kernel_q`` (int8) and ``kernel_scale`` (float32, one per output
channel) instead of ``kernel``, dequantized in the compute dtype.  Norm
statistics accumulate in float32 whatever the compute dtype.  ``*_specs``
build :class:`ParamSpec` subtrees with the JAX package's logical axes and
init rules.
``chunked_softmax_xent`` is the LM's loss, taken over chunks of the
sequence so that only one chunk's logits exist at a time.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.quantize import quantize_kernel
from repro_torch.param import spec
from repro_torch.sharding import (is_dtensor, per_device, per_shard,
                                  take_along, take_rows)


# ----------------------------------------------------------------- specs ----

def dense_specs(d_in: int, d_out: int, *, in_axis: Optional[str],
                out_axis: Optional[str], dtype: torch.dtype,
                bias: bool = False, quant: bool = False,
                zero_init: bool = False) -> dict:
    if quant:
        # int8 weight + per-output-channel float32 scale (serving residency)
        p = {"kernel_q": spec((d_in, d_out), (in_axis, out_axis),
                              dtype=torch.int8, init="zeros"),
             "kernel_scale": spec((d_out,), (out_axis,),
                                  dtype=torch.float32, init="ones")}
    else:
        p = {"kernel": spec((d_in, d_out), (in_axis, out_axis), dtype=dtype,
                            init="zeros" if zero_init else "normal",
                            fan_in_axes=(0,))}
    if bias:
        p["bias"] = spec((d_out,), (out_axis,), dtype=dtype, init="zeros")
    return p


def rmsnorm_specs(d: int, dtype: torch.dtype,
                  axis: Optional[str] = "embed") -> dict:
    return {"scale": spec((d,), (axis,), dtype=dtype, init="ones")}


def layernorm_specs(d: int, dtype: torch.dtype,
                    axis: Optional[str] = "embed") -> dict:
    return {"scale": spec((d,), (axis,), dtype=dtype, init="ones"),
            "bias": spec((d,), (axis,), dtype=dtype, init="zeros")}


def embed_specs(vocab: int, d: int, dtype: torch.dtype) -> dict:
    return {"embedding": spec((vocab, d), ("vocab", "embed"), dtype=dtype,
                              init="embed")}


def swiglu_specs(d: int, d_ff: int, dtype: torch.dtype, in_axis="embed",
                 out_axis="mlp", quant: bool = False) -> dict:
    kw = dict(dtype=dtype, quant=quant)
    return {"gate": dense_specs(d, d_ff, in_axis=in_axis, out_axis=out_axis,
                                **kw),
            "up": dense_specs(d, d_ff, in_axis=in_axis, out_axis=out_axis,
                              **kw),
            "down": dense_specs(d_ff, d, in_axis=out_axis, out_axis=in_axis,
                                **kw)}


def gelu_mlp_specs(d: int, d_ff: int, dtype: torch.dtype, in_axis="embed",
                   out_axis="mlp", quant: bool = False) -> dict:
    kw = dict(dtype=dtype, bias=True, quant=quant)
    return {"fc1": dense_specs(d, d_ff, in_axis=in_axis, out_axis=out_axis,
                               **kw),
            "fc2": dense_specs(d_ff, d, in_axis=out_axis, out_axis=in_axis,
                               **kw)}


# ---------------------------------------------------------------- apply ----

def dense(params: dict, x: torch.Tensor, compute_dtype: torch.dtype
          ) -> torch.Tensor:
    if "kernel_q" in params:
        # dequantize in the compute dtype, as the JAX package does (a
        # float32 product rounded afterwards would differ in bf16)
        w = (params["kernel_q"].to(compute_dtype)
             * params["kernel_scale"].to(compute_dtype))
    else:
        w = params["kernel"].to(compute_dtype)
    y = matmul(x.to(compute_dtype), w)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out).

    On DTensors it runs per device (``local_map``) in the layout GSPMD
    gives a dense layer, per mesh dim: a weight sharded on its output
    axis is column parallel (x replicated there, the output sharded on
    its last axis); else a weight sharded on its input axis is row
    parallel (x sharded on its last axis, the output a partial sum); else
    x keeps a shard of a leading axis and the weight is gathered (FSDP's
    all-gather).  A weight shard that meets a batch-sharded x on the same
    mesh dim is gathered too.  DTensor's own strategy is free to shard any
    axis of a replicated product, unevenly too (197 ViT tokens over 16
    devices), which the next op cannot broadcast."""
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    xs, ws, os_ = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        lead = isinstance(xp, Shard) and xp.dim < last
        if lead:
            xs.append(xp), ws.append(Replicate()), os_.append(xp)
        elif wp == Shard(1):
            xs.append(Replicate()), ws.append(wp), os_.append(Shard(last))
        elif wp == Shard(0):
            xs.append(Shard(last)), ws.append(wp), os_.append(Partial())
        else:
            xs.append(Replicate()), ws.append(Replicate())
            os_.append(Replicate())
    return per_device(lambda a, b: a @ b, os_, (xs, ws), x.device_mesh)(
        x, w)


def quantize_dense(kernel: torch.Tensor) -> dict:
    """A (d_in, d_out) kernel -> ``{kernel_q, kernel_scale}``, one scale
    per output channel."""
    q, scale = quantize_kernel(kernel, 1)
    return {"kernel_q": q, "kernel_scale": scale}


def _normalized(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last axis, in float32."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return (x32 - mean) * torch.rsqrt(var + eps)


def layernorm(params: dict, x: torch.Tensor, eps: float,
              compute_dtype: torch.dtype) -> torch.Tensor:
    y = _normalized(x, eps)
    if "scale" in params:
        y = (y * params["scale"].to(torch.float32)
             + params["bias"].to(torch.float32))
    return y.to(compute_dtype)


def modulated_layernorm(x: torch.Tensor, shift: torch.Tensor,
                        scale: torch.Tensor, eps: float,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """adaLN (DiT): a parameter-free layernorm of x (B, S, d) modulated by
    the conditioning's (B, d) ``shift`` and ``scale``, all in float32 and
    rounded once to the compute dtype."""
    y = (_normalized(x, eps) * (1.0 + scale.to(torch.float32)[:, None, :])
         + shift.to(torch.float32)[:, None, :])
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
    return take_rows(table, ids).to(compute_dtype)


def embed_logits(params: dict, x: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Tied read-out: x @ E^T."""
    table = params["embedding"].to(compute_dtype)
    return x.to(compute_dtype) @ table.T


class _Sigmoid(torch.autograd.Function):
    """1 / (1 + exp(-x)) with ``lax.logistic``'s derivative, g * (s * (1 -
    s)), taken from the output: differentiating the formula itself would
    give inf / inf = nan where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``'s arithmetic op by op, 1 / (1 + exp(-x)), so
    bf16 rounds where the JAX package rounds (``torch.sigmoid`` rounds
    once, and differs in the last bf16 bit on about a third of inputs);
    its gradient is the JAX package's too."""
    return _Sigmoid.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``, -softplus(-x) = min(x, 0) - log1p(exp(-|x|)),
    with its gradient 1 - sigmoid(x) (``jnp.logaddexp``'s, 0.5 at 0)."""
    return per_shard(F.logsigmoid, x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s arithmetic op by op, x * (1 / (1 + exp(-x))), so
    bf16 rounds where the JAX package rounds (``F.silu`` rounds once)."""
    return x * sigmoid(x)


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


def chunked_softmax_xent(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                         x: torch.Tensor, labels: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """The mean negative log-likelihood over the sequence, in chunks of
    ``chunk`` positions so that only one chunk's logits exist at a time.

    ``logits_fn(h) -> (B, c, V)``; x: (B, S, d); labels: (B, S).  Each
    chunk's logits are taken to float32; its loss is logsumexp minus the
    gold logit, summed and added to the total chunk by chunk in order; the
    total is divided by B * S.  The gold index is taken as the JAX
    package's ``take_along_axis(mode="clip")`` takes it: a negative one
    counts from the end, then it is clipped into [0, V - 1].
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        logits = logits_fn(x[:, i:i + chunk]).to(torch.float32)
        v = logits.shape[-1]
        gold_idx = labels[:, i:i + chunk].to(torch.int64)
        gold_idx = torch.where(gold_idx < 0, gold_idx + v,
                               gold_idx).clamp(0, v - 1)
        gold = take_along(logits, gold_idx, -1 % logits.ndim)
        total = total + (torch.logsumexp(logits, dim=-1) - gold).sum()
    return total / (b * s)
