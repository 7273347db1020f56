"""Activation recomputation for the training step: the port of the JAX
package's ``jax.checkpoint`` around a layer body.

:func:`run` calls a layer through ``torch.utils.checkpoint`` (non-
reentrant), so the backward pass recomputes what the forward pass did not
keep.  ``policy="dots"`` keeps the weight products, as JAX's
``dots_with_no_batch_dims_saveable`` does: an ``aten.mm``, or an
``aten.bmm`` of batch 1 (the form ``torch.einsum`` gives a product whose
operands share no batch axis); attention's score and context products
(batched over batch and heads) and every elementwise op are recomputed.
``policy="minimal"`` keeps only the layer's inputs.  Recomputation repeats
the same ops on the same inputs, so no value changes.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("dots", "minimal")


def _save_weight_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run(fn: Callable, *args, remat: bool, policy: str = "dots"):
    """``fn(*args)``, recomputed in the backward pass when ``remat`` and
    gradients are being recorded; plainly otherwise."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; choose from "
                         f"{list(POLICIES)}")
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_weight_products))
    return checkpoint(fn, *args, use_reentrant=False)
