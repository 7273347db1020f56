"""AdamW with a cosine schedule, warmup and global-norm clipping.

Port of ``repro/training/optimizer.py`` on trees of tensors (nested dicts
and lists, as the models' parameters are).  The moments are float32
whatever the parameter dtype; the update is taken in float32 and cast back
to the parameter dtype.  The arithmetic is the reference's, op for op: the
clip scale multiplies the float32 gradient before the moments, the bias
corrections divide the moments, and the weight decay is added to the step
(not applied apart afterwards, as ``torch.optim.AdamW`` does, whose bias
correction also differs).  Leaves are taken in ``jax.tree_util``'s order
(``param.sorted_leaves``), so the global norm sums in the reference's
order.  The JAX ``abstract_state`` (shape-only state for the dry run)
waits for ROADMAP item 14's meta-device dry run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from repro_torch.param import map_tree, replace_leaves, sorted_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio * lr`` at ``total_steps``; float32, on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init(params) -> dict:
    """Zero float32 moments in the parameters' tree and an int32 step
    count, on the parameters' devices."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = sorted_leaves(params)[0].device
    return {"m": map_tree(zeros32, params), "v": map_tree(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def convert_state(state: dict, convert: Callable) -> dict:
    """The JAX package's optimizer state (numpy arrays) -> the port's:
    ``m`` and ``v`` through ``convert`` (the model's ``convert_params``
    with ``dtype=torch.float32``: the parameters' tree), ``count`` an
    int32 scalar on their device."""
    m, v = convert(state["m"]), convert(state["v"])
    device = sorted_leaves(m)[0].device
    return {"m": m, "v": v,
            "count": torch.tensor(int(state["count"]), dtype=torch.int32,
                                  device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in sorted_leaves(tree)))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, state: dict, params
           ) -> Tuple[object, dict, dict]:
    """One AdamW step: (new params, new state, {grad_norm, lr})."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mh, vh = m / b1c, v / b2c
        p32 = p.to(torch.float32)
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * step).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        sorted_leaves(grads), sorted_leaves(state["m"]),
        sorted_leaves(state["v"]), sorted_leaves(params))]
    new_p = replace_leaves(params, (o[0] for o in out))
    new_m = replace_leaves(state["m"], (o[1] for o in out))
    new_v = replace_leaves(state["v"], (o[2] for o in out))
    return (new_p, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm, "lr": lr})
