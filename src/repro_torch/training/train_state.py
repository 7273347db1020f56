"""Train step factory: loss -> gradients -> optimizer, with optional
microbatch gradient accumulation in float32.

Port of ``repro/training/train_state.py``.  Gradients come from
``torch.autograd.grad`` on a copy of the parameters that requires them (the
caller's tensors are left alone, as ``jax.value_and_grad`` leaves them).
A leaf the loss does not reach (EfficientNet's kept batch-norm
statistics) gets a zero gradient, as ``jax.grad`` gives it.
``grad_pspecs`` (ZeRO-2 gradient sharding) lays each gradient out as its
parameter is laid out, inside a mesh (``sharding.py``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.compat import shardingx
from repro_torch.param import map_tree, replace_leaves, sorted_leaves
from repro_torch.sharding import is_dtensor, placements, replicated
from repro_torch.training import optimizer as opt


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, object]:
    """(loss, gradients in the parameters' tree and dtypes)."""
    leaves = [p.detach().requires_grad_(True) for p in sorted_leaves(params)]
    with torch.enable_grad():
        # a DTensor loss whole on every device: the backward pass starts
        # from one replicated seed, not from a pending sum's
        loss = replicated(loss_fn(replace_leaves(params, leaves), batch))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), replace_leaves(params, grads)


def constrain_grads(grads, grad_pspecs):
    """Each gradient redistributed to its ``PartitionSpec`` in
    ``grad_pspecs`` (a tree of the parameters' structure), inside a mesh
    and for DTensor gradients; the tree itself otherwise (the JAX
    ``with_sharding_constraint`` is a no-op outside a mesh)."""
    mesh = shardingx.get_abstract_mesh()
    if grad_pspecs is None or mesh is None:
        return grads

    def one(g, ps):
        if not is_dtensor(g):
            return g
        want = placements(ps, mesh)
        return g if tuple(g.placements) == want else g.redistribute(
            g.device_mesh, want)
    return replace_leaves(grads, (one(g, ps) for g, ps in zip(
        sorted_leaves(grads), sorted_leaves(grad_pspecs))))


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptimizerConfig,
                    accum_steps: int = 1, grad_pspecs=None) -> Callable:
    """loss_fn(params, batch) -> scalar.

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics ``loss``, ``grad_norm`` and ``lr`` (device scalars).  With
    ``accum_steps > 1`` the leading batch axis of every tensor in ``batch``
    is split into microbatches; their float32 gradients are summed in
    order and divided by ``accum_steps`` (and the losses likewise) before
    one optimizer step, as the reference's ``lax.scan`` does.

    ``grad_pspecs``: optional PartitionSpec tree matching the params.
    Constraining per-microbatch grads to the (FSDP-sharded) param specs
    turns the per-microbatch grad all-reduce into a reduce-scatter and
    accumulates sharded shards — ZeRO-2 gradient partitioning.
    """
    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = constrain_grads(grads, grad_pspecs)
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

            grads = map_tree(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=sorted_leaves(params)[0].device)
            for i in range(accum_steps):
                mb_loss, mb_grads = value_and_grad(loss_fn, params, micro(i))
                mb_grads = constrain_grads(mb_grads, grad_pspecs)
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
