"""EfficientNet (MBConv + SE) with compound scaling -- b7: w2.0 d3.1 r600.

Port of ``repro/models/efficientnet.py`` on :mod:`repro_torch.param`'s
``ParamSpec`` trees.  Activations and weights keep the reference's NHWC /
HWIO layouts at every function here; :func:`_conv` hands
``F.conv2d`` permuted views (NHWC is NCHW in channels-last memory, so the
activations are not transposed) and pads for XLA's ``"SAME"`` itself.  The convolutions are
cuDNN calls on a card, as the reference leaves them to XLA outside any
Pallas kernel: no hand kernel runs on this path.  A float32 config on a
card convolves in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False (PyTorch's default is True); bf16 configs are unaffected.

Batch norm takes the batch's statistics with ``train=True`` and the
running ones kept as parameters otherwise (the serve path).  The registry's
``efficientnet_b7`` detector reads :func:`count_params` for its weight
economics.  ``cls_loss`` (batch statistics, as the JAX loss takes them)
carries gradients; the kept statistics get none.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import EfficientNetConfig, dtype_of
from repro_torch.device import DeviceLike
from repro_torch.models.layers import sigmoid, silu
from repro_torch.param import convert_like
from repro_torch.param import count_params as _count
from repro_torch.param import init_params as init_tree
from repro_torch.param import spec
from repro_torch.sharding import (is_dtensor, per_device, take_along,
                                  with_logical_constraint)


def block_args(cfg: EfficientNetConfig) -> List[dict]:
    """Expand the B0 stage template with compound scaling."""
    blocks = []
    in_c = cfg.scaled_channels(cfg.stem_channels)
    for (expand, c, repeats, stride, k) in cfg.STAGES:
        out_c = cfg.scaled_channels(c)
        for i in range(cfg.scaled_repeats(repeats)):
            blocks.append(dict(
                in_c=in_c, out_c=out_c, expand=expand,
                stride=stride if i == 0 else 1, kernel=k))
            in_c = out_c
    return blocks


def _conv_specs(k: int, in_c: int, out_c: int, dtype, groups: int = 1):
    return {"kernel": spec((k, k, in_c // groups, out_c),
                           (None, None, "in_channels", None), dtype=dtype,
                           fan_in_axes=(0, 1, 2))}


def _bn_specs(c: int, dtype):
    return {
        "scale": spec((c,), (None,), dtype=dtype, init="ones"),
        "bias": spec((c,), (None,), dtype=dtype, init="zeros"),
        "mean": spec((c,), (None,), dtype=torch.float32, init="zeros"),
        "var": spec((c,), (None,), dtype=torch.float32, init="ones"),
    }


def _block_specs(b: dict, dtype):
    mid = b["in_c"] * b["expand"]
    se_c = max(1, int(b["in_c"] * 0.25))
    p = {}
    if b["expand"] != 1:
        p["expand_conv"] = _conv_specs(1, b["in_c"], mid, dtype)
        p["expand_bn"] = _bn_specs(mid, dtype)
    p["dw_conv"] = {"kernel": spec((b["kernel"], b["kernel"], 1, mid),
                                   (None, None, None, None), dtype=dtype,
                                   fan_in_axes=(0, 1))}
    p["dw_bn"] = _bn_specs(mid, dtype)
    p["se_reduce"] = _conv_specs(1, mid, se_c, dtype)
    p["se_expand"] = _conv_specs(1, se_c, mid, dtype)
    p["project_conv"] = _conv_specs(1, mid, b["out_c"], dtype)
    p["project_bn"] = _bn_specs(b["out_c"], dtype)
    return p


def param_specs(cfg: EfficientNetConfig):
    dtype = dtype_of(cfg.param_dtype)
    stem_c = cfg.scaled_channels(cfg.stem_channels)
    head_c = cfg.scaled_channels(cfg.head_channels)
    blocks = block_args(cfg)
    return {
        "stem_conv": _conv_specs(3, 3, stem_c, dtype),
        "stem_bn": _bn_specs(stem_c, dtype),
        "blocks": {f"block_{i}": _block_specs(b, dtype)
                   for i, b in enumerate(blocks)},
        "head_conv": _conv_specs(1, blocks[-1]["out_c"], head_c, dtype),
        "head_bn": _bn_specs(head_c, dtype),
        "classifier": {
            "kernel": spec((head_c, cfg.n_classes), ("embed", "vocab"),
                           dtype=dtype, fan_in_axes=(0,)),
            "bias": spec((cfg.n_classes,), ("vocab",), dtype=dtype,
                         init="zeros"),
        },
    }


def count_params(cfg: EfficientNetConfig) -> int:
    return _count(param_specs(cfg))


def init_params(cfg: EfficientNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the JAX package's init rules, drawn from
    ``generator`` on ``device``."""
    return init_tree(param_specs(cfg), generator, device)


def convert_params(tree: dict, cfg: EfficientNetConfig,
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's parameters (nested dicts of arrays) -> the port's
    tree on ``device``, each leaf in its spec's dtype (the batch-norm
    statistics float32, the rest ``cfg.param_dtype``). ``dtype``, when
    given, is every leaf's dtype instead (an optimizer state's float32
    moments, which have the parameters' tree)."""
    return convert_like(tree, param_specs(cfg), device, dtype)


# ------------------------------------------------------------------ ops -----

def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: the output has
    ceil(size / stride) positions; the total padding that needs goes one
    more to the high side when it is odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p: dict, x: torch.Tensor, stride: int, cdt: torch.dtype,
          groups: int = 1) -> torch.Tensor:
    """NHWC x, HWIO kernel -> NHWC, ``"SAME"`` padding, in ``cdt``.  On a
    DTensor the convolution runs on each device's batch shard with the
    kernel replicated (``local_map``): the data-parallel layout GSPMD
    gives these replicated weights, where DTensor's own convolution
    strategy may reshard the batch onto another mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    kernel = p["kernel"].to(cdt)
    if is_dtensor(x):
        xp = tuple(pl if pl == Shard(0) else Replicate()
                   for pl in x.placements)
        rep = (Replicate(),) * len(xp)
        return per_device(
            lambda a, w: _conv_local(a, w, stride, cdt, groups), xp,
            (xp, rep), x.device_mesh)(x, kernel)
    return _conv_local(x, kernel, stride, cdt, groups)



def _conv_local(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                cdt: torch.dtype, groups: int) -> torch.Tensor:
    k = kernel.shape[0]
    (top, bottom) = same_padding(x.shape[1], k, stride)
    (left, right) = same_padding(x.shape[2], k, stride)
    xc = x.to(cdt).permute(0, 3, 1, 2)
    if (top, left) == (bottom, right):
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=stride, padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _bn(p: dict, x: torch.Tensor, train: bool, cdt: torch.dtype,
        eps: float = 1e-3) -> torch.Tensor:
    """Batch norm over (B, H, W) in float32: the batch's statistics when
    ``train``, else the kept ``mean`` / ``var``; rounded once to ``cdt``."""
    x32 = x.to(torch.float32)
    if train:
        mean = x32.mean(dim=(0, 1, 2))
        var = x32.var(dim=(0, 1, 2), unbiased=False)
    else:
        mean, var = p["mean"].to(torch.float32), p["var"].to(torch.float32)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(cdt)


def _mbconv(p: dict, b: dict, x: torch.Tensor, train: bool,
            cdt: torch.dtype) -> torch.Tensor:
    """Expand (1x1) -> depthwise kxk at the block's stride -> squeeze-
    excite -> project (1x1), with the identity skip when shapes allow."""
    mid = b["in_c"] * b["expand"]
    inp = x
    if b["expand"] != 1:
        x = silu(_bn(p["expand_bn"], _conv(p["expand_conv"], x, 1, cdt),
                     train, cdt))
    x = silu(_bn(p["dw_bn"],
                 _conv(p["dw_conv"], x, b["stride"], cdt, groups=mid),
                 train, cdt))
    # squeeze-excite
    se = x.mean(dim=(1, 2), keepdim=True)
    se = silu(_conv(p["se_reduce"], se, 1, cdt))
    se = sigmoid(_conv(p["se_expand"], se, 1, cdt))
    x = x * se
    x = _bn(p["project_bn"], _conv(p["project_conv"], x, 1, cdt), train,
            cdt)
    if b["stride"] == 1 and b["in_c"] == b["out_c"]:
        x = x + inp
    return x


def forward(cfg: EfficientNetConfig, params: dict, images: torch.Tensor,
            *, train: bool = False) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, n_classes) in the compute
    dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    x = with_logical_constraint(images.to(cdt),
                                ("batch", "img_h", "img_w", None))
    x = silu(_bn(params["stem_bn"], _conv(params["stem_conv"], x, 2, cdt),
                 train, cdt))
    for i, b in enumerate(block_args(cfg)):
        x = _mbconv(params["blocks"][f"block_{i}"], b, x, train, cdt)
    x = silu(_bn(params["head_bn"], _conv(params["head_conv"], x, 1, cdt),
                 train, cdt))
    x = x.mean(dim=(1, 2))                        # global average pool
    return (x @ params["classifier"]["kernel"].to(cdt)
            + params["classifier"]["bias"].to(cdt))


def cls_loss(cfg: EfficientNetConfig, params: dict, batch: dict
             ) -> torch.Tensor:
    """batch: {images (B, H, W, 3), labels (B,)} -> the float32 mean
    cross-entropy of the training-mode forward pass, labels clamped into
    range."""
    lg = forward(cfg, params, batch["images"], train=True).to(torch.float32)
    labels = batch["labels"].to(torch.int64).clamp(0, cfg.n_classes - 1)
    gold = take_along(lg, labels, 1)
    return (torch.logsumexp(lg, -1) - gold).mean()


@torch.inference_mode()
def serve(cfg: EfficientNetConfig, params: dict, images: torch.Tensor
          ) -> torch.Tensor:
    """The serving forward pass: batch norm on the kept statistics."""
    return forward(cfg, params, images, train=False)
