"""Anchor-free single-stage detector on a ViT trunk (the Tangram model).

Port of ``repro/models/detector.py``: a ViT trunk over the canvas (patch
32 -> a 32x32 grid at 1024^2) with a per-cell head predicting (objectness,
cx, cy, w, h), and its training loss (grid-assigned targets, focal BCE on
objectness, L1 on the box at positive cells).  The trunk has no hand
kernel: the reference runs it through XLA with plain attention, the port
through ``torch.matmul``/einsum (cuBLAS on the card) in the compute dtype,
so the loss carries gradients.

Parameters are nested dicts of tensors in the JAX package's layouts, with
the stacked ``layers`` axis unstacked into a list (with ``quant_weights``
the trunk's attention and MLP kernels are int8, see :func:`param_specs`):

    {"trunk": {"patch_embed": {kernel (p*p*3, d), bias (d,)},
               "pos_embed": (1, side*side, d),
               "layers": [{"ln1", "attn": {wq, wk, wv, wo}, "ln2",
                           "mlp": {"fc1", "fc2"}}, ...],
               "ln_f": {scale, bias}},
     "det_head": {kernel (d, 5), bias (5,)}}

A ViTDet trunk (``DetectorConfig.window`` / ``global_every`` /
``rel_pos`` / ``attn_bias`` / ``gelu``; ``configs/vitdet_l.py``) adds to
each layer's ``attn`` the biases ``bq`` / ``bk`` / ``bv`` (H, Dh) and
``bo`` (d,), and the tables ``rel_pos_h`` / ``rel_pos_w`` (2 w - 1, Dh),
w the block's window or, in a global block, the grid's side; its blocks
attend within windows, partitioned after the first norm, but every
``global_every``-th (:func:`blocks`).  ``models/vitdet_reference.py`` is
its plain float32 reference.

:func:`init_params` draws them from a ``torch.Generator`` with the
reference's init rules (:func:`param_specs`); :func:`convert_params` takes
the JAX package's tree (as numpy arrays) instead.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import DetectorConfig, ViTConfig, dtype_of
from repro_torch.core import spans
from repro_torch.models import attention as attn
from repro_torch.models import layers, vit
from repro_torch.param import convert_like, map_tree, spec
from repro_torch.param import init_params as init_tree
from repro_torch.sharding import (is_dtensor, per_device,
                                  with_logical_constraint)


def trunk_cfg(cfg: DetectorConfig) -> ViTConfig:
    """The trunk's ViT config, the JAX package's ``_trunk_cfg`` (a
    one-class head, which the detector replaces with its own)."""
    return ViTConfig(
        name=f"{cfg.name}-trunk", img_res=cfg.canvas, patch=cfg.patch,
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.d_ff, n_classes=1, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, remat=cfg.remat,
        quant_weights=cfg.quant_weights)


# ------------------------------------------------------------ parameters ----

def param_specs(cfg: DetectorConfig) -> dict:
    """The detector's :class:`~repro_torch.param.ParamSpec` tree, with the
    reference's init rules.  With ``cfg.quant_weights`` the trunk's
    attention and MLP kernels are int8 ``{q, scale}`` /
    ``{kernel_q, kernel_scale, bias}``; the patch embed, position
    embedding, norms and head stay in ``cfg.param_dtype``."""
    dtype = dtype_of(cfg.param_dtype)
    d, h = cfg.d_model, cfg.n_heads
    quant = cfg.quant_weights
    side = cfg.canvas // cfg.patch

    def layer(i: int) -> dict:
        a = attn.gqa_specs(d, h, h, d // h, dtype, quant=quant)
        if cfg.attn_bias:
            a.update({name: spec((h, d // h), ("heads", "head_dim"),
                                 dtype=dtype, init="zeros")
                      for name in ("bq", "bk", "bv")})
            a["bo"] = spec((d,), ("embed",), dtype=dtype, init="zeros")
        if cfg.rel_pos:
            # (2 w - 1, Dh) for a block over a w x w grid: its window, or
            # the whole grid in a global block
            rows = 2 * (cfg.block_window(i) or side) - 1
            for name in ("rel_pos_h", "rel_pos_w"):
                a[name] = spec((rows, d // h), (None, "head_dim"),
                               dtype=dtype, fan_in_axes=(1,))
        return {"ln1": layers.layernorm_specs(d, dtype), "attn": a,
                "ln2": layers.layernorm_specs(d, dtype),
                "mlp": layers.gelu_mlp_specs(d, cfg.d_ff, dtype,
                                             quant=quant)}

    per_layer = ([layer(0)] * cfg.n_layers if cfg.plain
                 else [layer(i) for i in range(cfg.n_layers)])
    return {
        "trunk": {
            "patch_embed": layers.dense_specs(3 * cfg.patch * cfg.patch, d,
                                              in_axis="patch",
                                              out_axis="embed", dtype=dtype,
                                              bias=True),
            "pos_embed": spec((1, side * side, d), (None, "seq", "embed"),
                              dtype=dtype, init="pos"),
            "layers": per_layer,
            "ln_f": layers.layernorm_specs(d, dtype),
        },
        "det_head": layers.dense_specs(d, 5, in_axis="embed", out_axis=None,
                                       dtype=dtype, bias=True),
    }


def init_params(cfg: DetectorConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random parameters drawn on the host from ``generator`` (so a seed
    gives the same weights on every device), cast to the param dtype and
    moved to ``device``.  As in the JAX package, the int8 leaves of a
    ``quant_weights`` config are zeros: quantize a floating-point tree
    instead (``quantize.quantize_params``)."""
    host = init_tree(param_specs(cfg), generator, torch.device("cpu"))
    return map_tree(lambda t: t.to(device), host)


def convert_params(tree: dict, cfg: DetectorConfig,
                   device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's detector parameters (nested dicts of arrays) ->
    the port's tree.  Stacked layers (``trunk.layers`` with a leading
    ``n_layers`` axis, ``scan_layers=True``) are unstacked into a list;
    ``layer_{i}`` subtrees (under ``trunk.layers`` with
    ``scan_layers=False``, or in the trunk itself) are taken in order.
    Leaves are cast to ``cfg.param_dtype``, but for the int8-quantised
    weights of a ``quant_weights`` tree (``{q, scale}``,
    ``{kernel_q, kernel_scale}``), which keep int8 values and float32
    scales. ``dtype``, when given, is every leaf's dtype instead (an
    optimizer state's float32 moments, which have the parameters' tree)."""
    trunk = dict(tree["trunk"])
    # per-layer subtrees under trunk.layers, or beside it in the trunk
    if "layers" in trunk:
        layers_tree = trunk.pop("layers")
    elif "layer_0" in trunk:
        layers_tree = trunk
    else:
        raise KeyError("detector tree has neither trunk.layers nor "
                       "trunk.layer_0")
    if "layer_0" in layers_tree:
        names = [f"layer_{i}" for i in range(cfg.n_layers)]
        per_layer = [layers_tree[name] for name in names]
        for name in names:
            trunk.pop(name, None)
    else:
        per_layer = [map_tree(lambda a, i=i: np.asarray(a)[i], layers_tree)
                     for i in range(cfg.n_layers)]
    trunk["layers"] = per_layer
    out = {"trunk": trunk, "det_head": tree["det_head"]}
    return convert_like(out, param_specs(cfg), device, dtype)


def embed_params(cfg: DetectorConfig, params: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch-embed projection as (kernel, bias) in the compute dtype,
    the weights the fused stitch->embed kernel applies."""
    cdt = dtype_of(cfg.compute_dtype)
    pe = params["trunk"]["patch_embed"]
    return pe["kernel"].to(cdt), pe["bias"].to(cdt)


# ---------------------------------------------------------------- forward ----

def blocks(cfg: DetectorConfig) -> Optional[vit.Blocks]:
    """A ViTDet trunk's block pattern (grid side, each block's window,
    GELU form); None for the plain trunk."""
    if cfg.plain:
        return None
    return vit.Blocks(cfg.canvas // cfg.patch,
                      tuple(cfg.block_window(i) for i in range(cfg.n_layers)),
                      cfg.gelu)


def forward_tokens(cfg: DetectorConfig, params: dict, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Embedded tokens (B, seq, d_model) -> (B, side, side, 5) raw head."""
    cdt = dtype_of(cfg.compute_dtype)
    tp = params["trunk"]
    side = cfg.canvas // cfg.patch
    with spans.device_span("trunk", tokens):
        x = tokens.to(cdt) + tp["pos_embed"].to(cdt)
        x = with_logical_constraint(x, ("canvas", "seq", "embed"))
        x = vit.encoder(trunk_cfg(cfg), tp, x, blocks=blocks(cfg))
        out = layers.dense(params["det_head"], x, cdt)
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


def targets_from_boxes(cfg: DetectorConfig, boxes: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-assign ground-truth boxes (B, K, 4) xyxy, valid mask (B, K).

    Returns (obj_target (B, s, s), box_target (B, s, s, 4) = [dx, dy,
    log w, log h]), float32, as the JAX package's ``.at[...]`` scatters
    give them: a box's cell is its centre's, truncated toward zero and
    clipped into the grid; ``obj`` takes the max of ``valid`` over the
    boxes of a cell; ``box`` takes the last writer of a cell in (b, k)
    order, invalid boxes included (their values are zeroed, so a padding
    box after a real one in cell (0, 0) zeroes its target there while
    ``obj`` keeps its 1).  The last writer is made explicit because
    ``index_put_`` leaves the order of repeated indices undefined: the
    other writers go to a spare row past the grid, dropped after, so no
    shape depends on the data (the dry run's ``meta`` tensors hold none).
    On a DTensor batch each device assigns its own canvases.
    """
    if is_dtensor(boxes):
        from torch.distributed.tensor import Replicate, Shard
        pl = [p if p == Shard(0) else Replicate() for p in boxes.placements]
        return per_device(
            lambda bx, vd: targets_from_boxes(cfg, bx, vd), (pl, pl),
            (pl, pl), boxes.device_mesh)(boxes, valid)
    side = cfg.canvas // cfg.patch
    cell = cfg.canvas / side
    b, k, _ = boxes.shape
    boxes = boxes.to(torch.float32)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    gx = torch.clamp((cx / cell).to(torch.int32), 0, side - 1)
    gy = torch.clamp((cy / cell).to(torch.int32), 0, side - 1)
    valid32 = valid.to(torch.float32)
    vals = torch.stack([cx / cell - gx, cy / cell - gy,
                        torch.log(w / cell), torch.log(h / cell)], -1)
    vals = vals * valid32[..., None]

    bidx = torch.arange(b, device=boxes.device)[:, None]
    flat = ((bidx * side + gy) * side + gx).reshape(-1).to(torch.int64)
    n_cells = b * side * side
    obj_t = torch.zeros(n_cells, dtype=torch.float32, device=boxes.device)
    obj_t = obj_t.scatter_reduce(0, flat, valid32.reshape(-1), "amax")
    order = torch.arange(b * k, device=boxes.device)
    last = torch.full((n_cells,), -1, dtype=order.dtype,
                      device=boxes.device)
    last = last.scatter_reduce(0, flat, order, "amax")
    winner = order == last[flat]
    box_t = torch.zeros((n_cells + 1, 4), dtype=torch.float32,
                        device=boxes.device)
    box_t[torch.where(winner, flat, n_cells)] = vals.reshape(-1, 4)
    return (obj_t.reshape(b, side, side),
            box_t[:n_cells].reshape(b, side, side, 4))



def detection_loss(cfg: DetectorConfig, params: dict, batch: dict
                   ) -> torch.Tensor:
    """batch: {canvases (B, M, N, 3), boxes (B, K, 4), valid (B, K)} -> the
    float32 loss: the mean focal BCE on objectness (weight (1 - p)^2 at
    positive cells, p^2 elsewhere) plus the L1 on (sigmoid dx, sigmoid dy,
    log w, log h) summed over positive cells over their count (at least
    1), as the JAX package computes it."""
    raw = forward(cfg, params, batch["canvases"]).to(torch.float32)
    obj_t, box_t = targets_from_boxes(cfg, batch["boxes"], batch["valid"])
    obj_logit = raw[..., 0]
    p = layers.sigmoid(obj_logit)
    bce = -(obj_t * layers.log_sigmoid(obj_logit)
            + (1 - obj_t) * layers.log_sigmoid(-obj_logit))
    focal = bce * torch.where(obj_t > 0, (1 - p) ** 2, p ** 2)
    obj_loss = focal.mean()
    pred = torch.cat([layers.sigmoid(raw[..., 1:3]), raw[..., 3:5]], -1)
    l1 = torch.sum(torch.abs(pred - box_t), -1) * obj_t
    box_loss = l1.sum() / torch.clamp(obj_t.sum(), min=1.0)
    return obj_loss + box_loss


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
