"""Train step factory: loss -> gradients -> optimizer, with optional
microbatch gradient accumulation in float32.

Port of ``repro/training/train_state.py``.  Gradients come from
``torch.autograd.grad`` on a copy of the parameters that requires them (the
caller's tensors are left alone, as ``jax.value_and_grad`` leaves them).
A leaf the loss does not reach (EfficientNet's kept batch-norm
statistics) gets a zero gradient, as ``jax.grad`` gives it.  The JAX
``grad_pspecs`` (ZeRO-2 gradient sharding) waits for ROADMAP item 14.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.param import map_tree, replace_leaves, sorted_leaves
from repro_torch.training import optimizer as opt


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, object]:
    """(loss, gradients in the parameters' tree and dtypes)."""
    leaves = [p.detach().requires_grad_(True) for p in sorted_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(replace_leaves(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), replace_leaves(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptimizerConfig,
                    accum_steps: int = 1) -> Callable:
    """loss_fn(params, batch) -> scalar.

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics ``loss``, ``grad_norm`` and ``lr`` (device scalars).  With
    ``accum_steps > 1`` the leading batch axis of every tensor in ``batch``
    is split into microbatches; their float32 gradients are summed in
    order and divided by ``accum_steps`` (and the losses likewise) before
    one optimizer step, as the reference's ``lax.scan`` does.
    """
    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            def micro(i):
                def cut(x):
                    b = x.shape[0]
                    if b % accum_steps:
                        raise ValueError(f"batch {b} is not a multiple of "
                                         f"accum_steps {accum_steps}")
                    n = b // accum_steps
                    return x[i * n:(i + 1) * n]
                return {k: cut(x) for k, x in batch.items()}

            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=sorted_leaves(params)[0].device)
            for i in range(accum_steps):
                mb_loss, mb_grads = value_and_grad(loss_fn, params, micro(i))
                grads = replace_leaves(grads, (
                    a + g.to(torch.float32) for a, g in zip(
                        sorted_leaves(grads), sorted_leaves(mb_grads))))
                loss = loss + mb_loss
            loss = loss / accum_steps
            grads = map_tree(lambda g: g / accum_steps, grads)
        params, opt_state, metrics = opt.update(opt_cfg, grads, opt_state,
                                                params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
