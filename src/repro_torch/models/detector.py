"""Anchor-free single-stage detector on a ViT trunk (the Tangram model).

Port of the serving half of ``repro/models/detector.py``: a ViT trunk over
the canvas (patch 32 -> a 32x32 grid at 1024^2) with a per-cell head
predicting (objectness, cx, cy, w, h).  The trunk has no hand kernel: the
reference runs it through XLA, the port through ``torch.matmul``/einsum
(cuBLAS on the card) in the compute dtype.

Parameters are nested dicts of tensors in the JAX package's layouts, with
the stacked ``layers`` axis unstacked into a list:

    {"trunk": {"patch_embed": {kernel (p*p*3, d), bias (d,)},
               "pos_embed": (1, side*side, d),
               "layers": [{"ln1", "attn": {wq, wk, wv, wo}, "ln2",
                           "mlp": {"fc1", "fc2"}}, ...],
               "ln_f": {scale, bias}},
     "det_head": {kernel (d, 5), bias (5,)}}

:func:`init_params` draws them from a ``torch.Generator`` with the
reference's init rules; :func:`convert_params` takes the JAX package's
tree (as numpy arrays) instead.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.config import DetectorConfig, ViTConfig, dtype_of
from repro_torch.models import layers, vit
from repro_torch.param import from_numpy, map_tree


def trunk_cfg(cfg: DetectorConfig) -> ViTConfig:
    return ViTConfig(
        name=f"{cfg.name}-trunk", img_res=cfg.canvas, patch=cfg.patch,
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.d_ff, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype)


# ------------------------------------------------------------ parameters ----
# (shape, init, fan_in): init is "normal" (std 1/sqrt(fan_in)), "pos"
# (std 0.02), "zeros" or "ones" - the reference's ParamSpec rules.

def _dense(d_in: int, d_out: int) -> dict:
    return {"kernel": ((d_in, d_out), "normal", d_in),
            "bias": ((d_out,), "zeros", 0)}


def _norm(d: int) -> dict:
    return {"scale": ((d,), "ones", 0), "bias": ((d,), "zeros", 0)}


def param_shapes(cfg: DetectorConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    side = cfg.canvas // cfg.patch
    layer = {
        "ln1": _norm(d),
        "attn": {"wq": ((d, h, dh), "normal", d),
                 "wk": ((d, h, dh), "normal", d),
                 "wv": ((d, h, dh), "normal", d),
                 "wo": ((h, dh, d), "normal", h * dh)},
        "ln2": _norm(d),
        "mlp": {"fc1": _dense(d, cfg.d_ff), "fc2": _dense(cfg.d_ff, d)},
    }
    return {
        "trunk": {
            "patch_embed": _dense(3 * cfg.patch * cfg.patch, d),
            "pos_embed": ((1, side * side, d), "pos", 0),
            "layers": [layer] * cfg.n_layers,
            "ln_f": _norm(d),
        },
        "det_head": _dense(d, 5),
    }


def init_params(cfg: DetectorConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random parameters drawn on the host from ``generator`` (so a seed
    gives the same weights on every device), cast to the param dtype and
    moved to ``device``."""
    dtype = dtype_of(cfg.param_dtype)

    def leaf(spec):
        shape, init, fan_in = spec
        if init == "zeros":
            t = torch.zeros(shape)
        elif init == "ones":
            t = torch.ones(shape)
        else:
            std = 0.02 if init == "pos" else 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=generator) * std
        return t.to(device=device, dtype=dtype)

    return map_tree(leaf, param_shapes(cfg))


def convert_params(tree: dict, cfg: DetectorConfig,
                   device: torch.device) -> dict:
    """The JAX package's detector parameters (nested dicts of arrays) ->
    the port's tree.  Stacked layers (``trunk.layers`` with a leading
    ``n_layers`` axis, ``scan_layers=True``) are unstacked into a list;
    ``layer_{i}`` subtrees are taken in order.  Leaves are cast to
    ``cfg.param_dtype``."""
    dtype = dtype_of(cfg.param_dtype)
    trunk = dict(tree["trunk"])
    if "layers" in trunk:
        stacked = trunk.pop("layers")
        per_layer = [map_tree(lambda a, i=i: np.asarray(a)[i], stacked)
                     for i in range(cfg.n_layers)]
    else:
        per_layer = [trunk.pop(f"layer_{i}") for i in range(cfg.n_layers)]
    trunk["layers"] = per_layer
    out = {"trunk": trunk, "det_head": tree["det_head"]}
    return map_tree(lambda a: from_numpy(a, dtype, device), out)


def embed_params(cfg: DetectorConfig, params: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch-embed projection as (kernel, bias) in the compute dtype,
    the weights the fused stitch->embed kernel applies."""
    cdt = dtype_of(cfg.compute_dtype)
    pe = params["trunk"]["patch_embed"]
    return pe["kernel"].to(cdt), pe["bias"].to(cdt)


# ---------------------------------------------------------------- forward ----

def forward_tokens(cfg: DetectorConfig, params: dict, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Embedded tokens (B, seq, d_model) -> (B, side, side, 5) raw head."""
    cdt = dtype_of(cfg.compute_dtype)
    tp = params["trunk"]
    x = tokens.to(cdt) + tp["pos_embed"].to(cdt)
    x = vit.encoder(trunk_cfg(cfg), tp, x)
    out = layers.dense(params["det_head"], x, cdt)
    side = cfg.canvas // cfg.patch
    return out.reshape(tokens.shape[0], side, side, 5)


def forward(cfg: DetectorConfig, params: dict, canvases: torch.Tensor
            ) -> torch.Tensor:
    """canvases: (B, M, N, 3) -> (B, side, side, 5) raw head outputs."""
    cdt = dtype_of(cfg.compute_dtype)
    x = layers.dense(params["trunk"]["patch_embed"],
                     vit.patchify(canvases, cfg.patch), cdt)
    return forward_tokens(cfg, params, x)


def decode_boxes(cfg: DetectorConfig, raw: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """raw: (B, s, s, 5) -> (obj_prob (B, s, s), boxes xyxy (B, s, s, 4)
    in canvas pixels), float32."""
    side = raw.shape[1]
    cell = cfg.canvas / side
    r = raw.to(torch.float32)
    obj = torch.sigmoid(r[..., 0])
    grid = torch.arange(side, device=raw.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    cx = (gx + torch.sigmoid(r[..., 1])) * cell
    cy = (gy + torch.sigmoid(r[..., 2])) * cell
    w = torch.exp(torch.clamp(r[..., 3], -6, 6)) * cell
    h = torch.exp(torch.clamp(r[..., 4], -6, 6)) * cell
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return obj, boxes


@torch.inference_mode()
def serve(cfg: DetectorConfig, params: dict, canvases: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serverless function body: canvases -> (obj, boxes)."""
    return decode_boxes(cfg, forward(cfg, params, canvases))


def tokens_fn(cfg: DetectorConfig) -> Callable:
    """``fn(params, tokens) -> raw head``: the trunk from embedded tokens,
    the shape the fused device executors call."""
    @torch.inference_mode()
    def fn(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        return forward_tokens(cfg, params, tokens)
    return fn


def serve_fn(cfg: DetectorConfig) -> Callable:
    """``fn(params, canvases) -> (obj, boxes)`` for one config, the shape
    the device executors call."""
    def fn(params: Dict, canvases: torch.Tensor):
        return serve(cfg, params, canvases)
    return fn
