"""Training driver: data -> train steps -> checkpoints, with failure
drills (restore the latest checkpoint and go on).

Port of ``repro/launch/train.py`` and of the loss dispatch of
``repro/api.py`` (``loss_fn``; the rest of ``api.py`` waits for ROADMAP
item 14).  ``train`` runs any config on one device: the CLI trains the
reduced configs (``--reduced`` is on, as in the reference, whose flag
cannot be turned off); full width is reached by calling :func:`train`
with a registry config.  Every loss takes the reference's training path,
which launches no hand kernel (the trunks' attention is ``"xla"``).
``--device`` (default ``cuda``) is the one flag the port adds; ``cpu``
runs everything on the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tangram-detector \\
      --steps 20 --batch 4 --ckpt-dir /tmp/ckpt --drill-step 10 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import configs as cfg_registry
from repro_torch import param as param_lib
from repro_torch.config import (DetectorConfig, DiTConfig,
                                EfficientNetConfig, ShapeConfig,
                                TransformerConfig, ViTConfig)
from repro_torch.data import loader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import detector, dit, efficientnet, transformer, vit
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.elastic import FailureEvent, FailureInjector
from repro_torch.training.train_state import make_train_step


def reduced_config(model):
    """Shrink an LM or detector config to a CPU-trainable size (same
    family), as the reference does."""
    if isinstance(model, TransformerConfig):
        return dataclasses.replace(
            model, n_layers=2, d_model=128, n_heads=4, n_kv_heads=min(
                model.n_kv_heads, 4), d_ff=256, vocab=512, head_dim=32,
            param_dtype="float32", compute_dtype="float32", remat=False,
            moe=dataclasses.replace(model.moe, n_experts=4, top_k=min(
                model.moe.top_k, 2), d_ff_expert=64, group_size=64)
            if model.moe else None)
    if isinstance(model, DetectorConfig):
        return dataclasses.replace(model, canvas=256, patch=32, n_layers=2,
                                   d_model=64, n_heads=4, d_ff=128,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    raise TypeError(f"reduced training not wired for {type(model)}")


_MODULES = ((TransformerConfig, transformer), (ViTConfig, vit),
            (DiTConfig, dit), (EfficientNetConfig, efficientnet),
            (DetectorConfig, detector))


def model_module(model):
    """The models module of a config's family."""
    for cls, module in _MODULES:
        if isinstance(model, cls):
            return module
    raise TypeError(type(model))


def loss_fn(model, impl: str = "xla") -> Callable:
    """``fn(params, batch) -> scalar`` loss of a config's family (the
    reference's ``api._loss_fn``); ``impl`` is the LM's attention path
    (``"xla"`` or ``"chunked"``)."""
    if isinstance(model, TransformerConfig):
        return lambda p, b: transformer.lm_loss(model, p, b, impl=impl)
    if isinstance(model, ViTConfig):
        return lambda p, b: vit.cls_loss(model, p, b)
    if isinstance(model, DiTConfig):
        return lambda p, b: dit.diffusion_loss(model, p, b)
    if isinstance(model, EfficientNetConfig):
        return lambda p, b: efficientnet.cls_loss(model, p, b)
    if isinstance(model, DetectorConfig):
        return lambda p, b: detector.detection_loss(model, p, b)
    raise TypeError(type(model))


def make_data(model, shape: ShapeConfig, seed: int = 0):
    if isinstance(model, TransformerConfig):
        return loader.lm_batches(model.vocab, shape.global_batch,
                                 shape.seq_len, seed=seed)
    if isinstance(model, DetectorConfig):
        return loader.detector_batches(model.canvas, shape.global_batch,
                                       seed=seed)
    raise TypeError(type(model))


def init_params(model, seed: int, device: torch.device) -> dict:
    """The family's parameters, drawn on ``device`` from a generator there
    seeded with ``seed`` (the reference draws from ``PRNGKey(seed)``; the
    numbers differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return param_lib.init_params(model_module(model).param_specs(model),
                                 gen, device)


def to_device(batch: dict, device: torch.device) -> dict:
    """A loader batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(model, shape: ShapeConfig, *, steps: int, ckpt_dir: Optional[str],
          ckpt_every: int = 20, seed: int = 0,
          injector: Optional[FailureInjector] = None,
          opt_cfg: Optional[opt_lib.OptimizerConfig] = None,
          log_every: int = 10, device: DeviceLike = None):
    """Single-device training loop with resume and failure drills; returns
    (params, losses of the steps run).

    Resumes from the latest checkpoint in ``ckpt_dir``, saves every
    ``ckpt_every`` steps and after the last.  When ``injector`` fires at a
    step, the parameters and optimizer state are restored from the latest
    checkpoint; the step counter and the data iterator go on where they
    are, as in the reference.
    """
    device = resolve_device(device)
    opt_cfg = opt_cfg or opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)

    params = init_params(model, seed, device)
    opt_state = opt_lib.init(params)
    start_step = 0
    if ckpt_dir:
        restored, at = ckpt_lib.restore_latest(ckpt_dir,
                                               {"p": params, "o": opt_state})
        if restored is not None:
            params, opt_state = restored["p"], restored["o"]
            start_step = at
            print(f"resumed from step {at}")

    step_fn = make_train_step(loss_fn(model), opt_cfg)
    data = make_data(model, shape, seed=seed)
    losses = []
    for step in range(start_step, steps):
        if injector:
            for ev in injector.poll(step):
                # failure drill: drop state, restore latest checkpoint
                print(f"[drill] {ev.kind} at step {step}: "
                      f"restoring latest checkpoint")
                restored, _ = ckpt_lib.restore_latest(
                    ckpt_dir, {"p": params, "o": opt_state})
                if restored is None:
                    raise RuntimeError("failure drill: no checkpoint to "
                                       "recover from")
                params, opt_state = restored["p"], restored["o"]
        batch = to_device(next(data), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0:
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1, {"p": params, "o": opt_state})
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, {"p": params, "o": opt_state})
    return params, losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tangram-detector",
                   choices=cfg_registry.ARCH_IDS)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--ckpt-dir")
    p.add_argument("--drill-step", type=int,
                   help="inject a failure drill at this step")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    arch = cfg_registry.get(args.arch)
    model = reduced_config(arch) if args.reduced else arch
    if isinstance(model, TransformerConfig):
        shape = ShapeConfig("train", "train", seq_len=args.seq,
                            global_batch=args.batch)
    else:
        shape = ShapeConfig("train", "train", img_res=model.canvas,
                            global_batch=args.batch)
    injector = None
    if args.drill_step:
        injector = FailureInjector(
            [FailureEvent(args.drill_step, "host", 0)])
    t0 = time.time()
    _, losses = train(model, shape, steps=args.steps,
                      ckpt_dir=args.ckpt_dir, injector=injector,
                      device=args.device)
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
