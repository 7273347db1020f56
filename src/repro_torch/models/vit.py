"""ViT / DeiT encoder classifiers, and the encoder the detector trunk runs.

Port of ``repro/models/vit.py``.  Patch embedding is part of the model;
DeiT adds a distillation token and a second head, and at serve time the
two heads' logits are averaged (the DeiT inference rule).  Parameters are
nested dicts of tensors in the JAX package's layouts, with the stacked
``layers`` axis unstacked into a list (the JAX tree stacks them on a
leading ``n_layers`` axis for ``lax.scan``; here the encoder is a Python
loop):

    {"patch_embed": {kernel (p*p*C, d), bias (d,)}  ("reshape"), or
                    {kernel (p, p, C, d), bias (d,)}  ("conv"),
     "cls_token": (1, 1, d), "pos_embed": (1, n_tokens, d),
     "layers": [{"ln1", "attn": {wq, wk, wv, wo}, "ln2",
                 "mlp": {"fc1", "fc2"}}, ...],
     "ln_f": {scale, bias}, "head": {kernel (d, n_classes), bias},
     DeiT: "dist_token": (1, 1, d), "head_dist": {kernel, bias}}

The encoder's attention is ``attention.encoder_attention``: ``impl="xla"``
(the default, as in the JAX package) is plain attention, ``impl="flash"``
runs K6 non-causal on a CUDA tensor.  ``cls_loss`` carries gradients
(its default ``impl="xla"`` launches no kernel); with ``cfg.remat`` each
layer is recomputed in the backward pass, its weight products kept
(``models/remat.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ViTConfig, dtype_of
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models import layers, remat
from repro_torch.param import convert_like, map_tree, spec
from repro_torch.param import init_params as init_tree
from repro_torch.sharding import (per_shard, replicated, take_along,
                                  with_logical_constraint)


# ------------------------------------------------------------ parameters ----

def _layer_specs(cfg: ViTConfig, dtype: torch.dtype) -> dict:
    quant = cfg.quant_weights
    return {
        "ln1": layers.layernorm_specs(cfg.d_model, dtype),
        "attn": attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_heads,
                               cfg.d_model // cfg.n_heads, dtype,
                               fused=cfg.fused_qkv, quant=quant),
        "ln2": layers.layernorm_specs(cfg.d_model, dtype),
        "mlp": layers.gelu_mlp_specs(cfg.d_model, cfg.d_ff, dtype,
                                     quant=quant),
    }


def param_specs(cfg: ViTConfig) -> dict:
    """The classifier's :class:`~repro_torch.param.ParamSpec` tree, with
    the JAX package's shapes and init rules."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    patch_dim = cfg.in_channels * cfg.patch * cfg.patch
    if cfg.patch_embed == "conv":
        pe = {"kernel": spec((cfg.patch, cfg.patch, cfg.in_channels, d),
                             (None, None, "in_channels", "embed"),
                             dtype=dtype, fan_in_axes=(0, 1, 2)),
              "bias": spec((d,), ("embed",), dtype=dtype, init="zeros")}
    else:
        pe = layers.dense_specs(patch_dim, d, in_axis="patch",
                                out_axis="embed", dtype=dtype, bias=True)
    p = {
        "patch_embed": pe,
        "cls_token": spec((1, 1, d), (None, None, "embed"), dtype=dtype,
                          init="pos"),
        "pos_embed": spec((1, cfg.n_tokens, d), (None, "seq", "embed"),
                          dtype=dtype, init="pos"),
        "layers": [_layer_specs(cfg, dtype)] * cfg.n_layers,
        "ln_f": layers.layernorm_specs(d, dtype),
        "head": layers.dense_specs(d, cfg.n_classes, in_axis="embed",
                                   out_axis="vocab", dtype=dtype, bias=True),
    }
    if cfg.distill_token:
        p["dist_token"] = spec((1, 1, d), (None, None, "embed"), dtype=dtype,
                               init="pos")
        p["head_dist"] = layers.dense_specs(d, cfg.n_classes, in_axis="embed",
                                            out_axis="vocab", dtype=dtype,
                                            bias=True)
    return p


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the JAX package's init rules, drawn from
    ``generator`` on ``device`` (a CUDA generator draws them on the
    card)."""
    return init_tree(param_specs(cfg), generator, device)


def unstack_layers(stacked, n_layers: int) -> list:
    """A JAX ``layers`` subtree -> a list of per-layer subtrees: leaves
    with a leading ``n_layers`` axis (``scan_layers=True``) are cut along
    it, ``layer_{i}`` dicts (``scan_layers=False``) taken in order."""
    if "layer_0" in stacked:
        return [stacked[f"layer_{i}"] for i in range(n_layers)]
    return [map_tree(lambda a, i=i: np.asarray(a)[i], stacked)
            for i in range(n_layers)]


def convert_params(tree: dict, cfg: ViTConfig,
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's classifier parameters (nested dicts of arrays,
    e.g. via ``np.asarray``) -> the port's tree on ``device``: the stacked
    layers unstacked into a list, each leaf cast to its spec's dtype (bf16
    keeps its bits). ``dtype``, when given, is every leaf's dtype instead
    (an optimizer state's float32 moments, which have the parameters'
    tree)."""
    out = dict(tree)
    out["layers"] = unstack_layers(tree["layers"], cfg.n_layers)
    return convert_like(out, param_specs(cfg), device, dtype)


# ---------------------------------------------------------------- forward ----

def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C), the JAX package's layout."""
    b, hh, ww, c = images.shape
    h, w = hh // patch, ww // patch
    x = images.reshape(b, h, patch, w, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def _block(cfg: ViTConfig, lp: dict, x: torch.Tensor,
           impl: str) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    h = layers.layernorm(lp["ln1"], x, cfg.norm_eps, cdt)
    x = x + attn.encoder_attention(lp["attn"], h, compute_dtype=cdt,
                                   impl=impl)
    h = layers.layernorm(lp["ln2"], x, cfg.norm_eps, cdt)
    return x + layers.gelu_mlp(lp["mlp"], h, cdt)


def encoder(cfg: ViTConfig, params: dict, x: torch.Tensor,
            impl: str = "xla") -> torch.Tensor:
    """Pre-norm transformer blocks over ``params["layers"]``, then the
    final layernorm; ``impl`` as ``attention.encoder_attention`` takes
    it."""
    for lp in params["layers"]:
        x = remat.run(_block, cfg, lp, x, impl, remat=cfg.remat)
    return layers.layernorm(params["ln_f"], x, cfg.norm_eps,
                            dtype_of(cfg.compute_dtype))


def resize_grid(grid_pos: torch.Tensor, side: int) -> torch.Tensor:
    """(1, s*s, d) position embeddings of an s x s patch grid -> (1,
    side*side, d), bilinear, as ``jax.image.resize(..., "bilinear")``
    resizes: half-pixel centres, and when it shrinks the grid a triangle
    filter as wide as the scale (its default antialiasing), which is
    ``F.interpolate``'s ``antialias=True``.  Computed in float32, rounded
    to the input dtype."""
    old = int(round(grid_pos.shape[1] ** 0.5))
    g = grid_pos.reshape(1, old, old, -1).permute(0, 3, 1, 2)
    g = F.interpolate(g.to(torch.float32), size=(side, side),
                      mode="bilinear", align_corners=False,
                      antialias=side < old)
    return g.permute(0, 2, 3, 1).reshape(1, side * side, -1).to(
        grid_pos.dtype)


def forward(cfg: ViTConfig, params: dict, images: torch.Tensor, *,
            impl: str = "xla", img_res: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """images: (B, H, W, C) -> (logits (B, n_classes), heads).  ``heads``
    is None for ViT and DeiT's (cls, distillation) logits, whose average
    is ``logits``.

    Images of another size than ``cfg.img_res`` (the cls_384 cell) get
    the position embedding of their grid resized bilinearly, as in the
    ViT paper; ``img_res``, when given, must be the images' size.
    """
    cdt = dtype_of(cfg.compute_dtype)
    b = images.shape[0]
    if img_res is not None and images.shape[1] != img_res:
        raise ValueError(f"img_res {img_res} but images of "
                         f"{tuple(images.shape[1:3])}")
    pe = params["patch_embed"]
    x = patchify(images.to(cdt), cfg.patch)
    if cfg.patch_embed == "conv":
        # the strided VALID conv stem is this product: its (p, p, C, d)
        # kernel flattens in patchify's (py, px, c) order
        pe = {"kernel": pe["kernel"].reshape(-1, pe["kernel"].shape[-1]),
              "bias": pe["bias"]}
    x = layers.dense(pe, x, cdt)

    n_extra = 1 + (1 if cfg.distill_token else 0)
    pos = params["pos_embed"].to(cdt)
    grid_pos = pos[:, n_extra:, :]
    n_patches = x.shape[1]
    if n_patches != grid_pos.shape[1]:
        side = int(round(n_patches ** 0.5))
        grid_pos = per_shard(lambda g: resize_grid(g, side),
                             replicated(grid_pos))
    x = x + grid_pos

    d = x.shape[-1]
    toks = [(params["cls_token"].to(cdt) + pos[:, :1, :]).expand(b, 1, d)]
    if cfg.distill_token:
        toks.append((params["dist_token"].to(cdt)
                     + pos[:, 1:2, :]).expand(b, 1, d))
    x = torch.cat(toks + [x], dim=1)
    x = with_logical_constraint(x, ("batch", "seq", "embed"))

    x = encoder(cfg, params, x, impl)
    logits = layers.dense(params["head"], x[:, 0, :], cdt)
    if cfg.distill_token:
        logits_d = layers.dense(params["head_dist"], x[:, 1, :], cdt)
        return (logits + logits_d) / 2.0, (logits, logits_d)
    return logits, None


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = logits.to(torch.float32)
    gold = take_along(lg, labels, 1)
    return (torch.logsumexp(lg, -1) - gold).mean()


def cls_loss(cfg: ViTConfig, params: dict, batch: dict, *,
             impl: str = "xla") -> torch.Tensor:
    """batch: {images (B, H, W, C), labels (B,)} -> the float32 mean
    cross-entropy, labels clamped into range; DeiT averages its two
    heads' losses."""
    logits, heads = forward(cfg, params, batch["images"], impl=impl)
    labels = batch["labels"].to(torch.int64).clamp(0, cfg.n_classes - 1)
    if heads is not None:
        return 0.5 * (_xent(heads[0], labels) + _xent(heads[1], labels))
    return _xent(logits, labels)


@torch.inference_mode()
def serve(cfg: ViTConfig, params: dict, images: torch.Tensor, *,
          impl: str = "xla") -> torch.Tensor:
    """images -> logits (DeiT: the two heads averaged)."""
    logits, _ = forward(cfg, params, images, impl=impl)
    return logits
