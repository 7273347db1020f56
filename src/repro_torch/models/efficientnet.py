"""EfficientNet (MBConv + SE) with compound scaling: its parameter specs.

Port of ``block_args``, ``param_specs`` and ``count_params`` from
``repro/models/efficientnet.py``, on :mod:`repro_torch.param`'s
``ParamSpec`` trees (NHWC / HWIO layouts, as the reference's).  The
registry's ``efficientnet_b7`` detector reads :func:`count_params` for its
weight economics; the classifier's forward pass (convolutions, sync
batch norm, squeeze-excite) is ROADMAP item 13.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.config import EfficientNetConfig, dtype_of
from repro_torch.param import count_params as _count
from repro_torch.param import spec


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
    return {"kernel": spec((k, k, in_c // groups, out_c), dtype=dtype,
                           fan_in_axes=(0, 1, 2))}


def _bn_specs(c: int, dtype):
    return {
        "scale": spec((c,), dtype=dtype, init="ones"),
        "bias": spec((c,), dtype=dtype, init="zeros"),
        "mean": spec((c,), dtype=torch.float32, init="zeros"),
        "var": spec((c,), dtype=torch.float32, init="ones"),
    }


def _block_specs(b: dict, dtype):
    mid = b["in_c"] * b["expand"]
    se_c = max(1, int(b["in_c"] * 0.25))
    p = {}
    if b["expand"] != 1:
        p["expand_conv"] = _conv_specs(1, b["in_c"], mid, dtype)
        p["expand_bn"] = _bn_specs(mid, dtype)
    p["dw_conv"] = {"kernel": spec((b["kernel"], b["kernel"], 1, mid),
                                   dtype=dtype, fan_in_axes=(0, 1))}
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
            "kernel": spec((head_c, cfg.n_classes), dtype=dtype,
                           fan_in_axes=(0,)),
            "bias": spec((cfg.n_classes,), dtype=dtype, init="zeros"),
        },
    }


def count_params(cfg: EfficientNetConfig) -> int:
    return _count(param_specs(cfg))
