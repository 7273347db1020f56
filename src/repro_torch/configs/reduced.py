"""Reduced same-family configs for CPU tests and rehearsals.

Port of ``reduce_arch`` from ``repro/configs/reduced.py`` for the families
the port runs: the same numbers, so a reduced JAX config and a reduced
port config describe the same model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.config import (DetectorConfig, DiTConfig,
                                EfficientNetConfig, TransformerConfig,
                                ViTConfig)


def reduce_arch(model):
    """A full config -> a small CPU-runnable config of the same family."""
    if isinstance(model, TransformerConfig):
        moe = None
        if model.moe is not None:
            # MoE stays MoE with shared experts
            moe = dataclasses.replace(
                model.moe, n_experts=min(model.moe.n_experts, 8),
                top_k=min(model.moe.top_k, 2),
                n_shared=min(model.moe.n_shared, 1),
                d_ff_expert=64, group_size=64)
        return dataclasses.replace(
            model, n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2 if model.n_kv_heads < model.n_heads else 4,
            d_ff=256, vocab=512, head_dim=32, moe=moe,
            param_dtype="float32", compute_dtype="float32", remat=False)
    if isinstance(model, ViTConfig):
        return dataclasses.replace(
            model, img_res=64, patch=16, n_layers=2, d_model=64, n_heads=4,
            d_ff=128, n_classes=16, param_dtype="float32",
            compute_dtype="float32", remat=False)
    if isinstance(model, DiTConfig):
        return dataclasses.replace(
            model, img_res=64, patch=2, n_layers=2, d_model=64, n_heads=4,
            n_classes=16, param_dtype="float32", compute_dtype="float32",
            remat=False)
    if isinstance(model, EfficientNetConfig):
        return dataclasses.replace(
            model, img_res=64, width_mult=0.35, depth_mult=0.35,
            n_classes=16, param_dtype="float32", compute_dtype="float32")
    if isinstance(model, DetectorConfig):
        return dataclasses.replace(
            model, canvas=128, patch=32, n_layers=2, d_model=64, n_heads=4,
            d_ff=128, param_dtype="float32", compute_dtype="float32")
    raise TypeError(type(model))
