"""Cell planning: (architecture x shape x mesh) -> step + shardings.

Port of ``repro/api.py``.  :func:`plan_cell` is the one entry point of the
dry run (``launch/dryrun.py``) and its tests.  It returns the step
function, abstract arguments — ``meta`` tensors, so nothing is allocated
for 100B-parameter cells — and the in / out layouts as trees of
``sharding.PartitionSpec``, resolved from the logical-axis rules with the
divisibility fixups for the concrete mesh.

Where the JAX package lowers the planned step under ``jax.jit``
(``lower_cell``), the port runs it: :func:`run_abstract` lays every
argument out as a DTensor of ``meta`` tensors on the mesh's
``DeviceMesh`` (a fake process group; ``compat.shardingx.device_mesh``)
and calls the step eagerly under ``use_mesh`` (the models' logical
constraints read the mesh and the plan's rules) and DTensor's
``implicit_replication`` (the plain tensors a model makes inside — RoPE
tables, masks, ``arange``s — join as replicated).  Nothing runs on a card
and nothing is allocated; the counters of ``launch/hlo_analysis.py`` read
every op of that run.

The port's parameter and cache trees hold one subtree a layer
(``layer_{i}`` dicts, or lists), the JAX package's unscanned form: a JAX
leaf stacked over layers, (L, ...) with the leading axis "layers" (never
sharded), is L leaves here, each of the stacked leaf's shape and spec
without that axis.  The decode step takes ``pos`` as a meta int32 scalar,
as the JAX plan does; the step decodes at the last position of the cache
(the meta device holds no value), which costs what any position costs:
the decode attends over the whole cache, masked.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import param as param_lib
from repro_torch.compat import shardingx
from repro_torch.config import (DetectorConfig, DiTConfig,
                                EfficientNetConfig, ShapeConfig,
                                TransformerConfig, ViTConfig)
from repro_torch.launch.train import loss_fn as _train_loss_fn
from repro_torch.launch.train import model_module as _model_module
from repro_torch.models import detector as detector_lib
from repro_torch.models import dit as dit_lib
from repro_torch.models import transformer as tfm_lib
from repro_torch.sharding import (PartitionSpec, Rules, divisible_spec,
                                  local_shape, placements)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str                    # train | prefill | decode | gen | serve
    step_fn: Callable
    args: Tuple[Any, ...]        # abstract trees (meta tensors)
    in_shardings: Tuple[Any, ...]   # trees of PartitionSpec
    out_shardings: Any
    n_params: int
    n_active_params: int
    notes: str = ""
    # dry-run scaling: the planned program is one repeated unit (a
    # microbatch / one sampler step); the full step = scale x this unit.
    scale: float = 1.0
    # the rule table the step's logical constraints resolve through
    rules: Optional[Rules] = None


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, str) for a in x))


def _shard_tree(mesh, abstract_tree, axes_tree, rules: Rules):
    """Zip an abstract tree with a parallel tree of logical-axes tuples
    into a tree of divisible specs."""
    if isinstance(abstract_tree, dict):
        return {k: _shard_tree(mesh, v, axes_tree[k], rules)
                for k, v in abstract_tree.items()}
    if isinstance(abstract_tree, list):
        return [_shard_tree(mesh, v, a, rules)
                for v, a in zip(abstract_tree, axes_tree)]
    assert _is_axes_leaf(axes_tree), axes_tree
    return divisible_spec(abstract_tree.shape, axes_tree, rules, mesh)


def _opt_shardings(param_shardings):
    return {"m": param_shardings, "v": param_shardings,
            "count": PartitionSpec()}


def _metric_shardings():
    rep = PartitionSpec()
    return {"grad_norm": rep, "lr": rep, "loss": rep}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ------------------------------------------------------------- factories ----


def param_specs(cfg):
    return _model_module(cfg).param_specs(cfg)


def _loss_fn(cfg, rules: Optional[Rules] = None, impl: str = "xla",
             unroll_loss: bool = False):
    """The family's loss (``launch/train.loss_fn``).  ``rules`` and
    ``unroll_loss`` are the JAX signature's: the port's models read the
    ambient rules, and its LM loss is a Python loop over chunks already."""
    return _train_loss_fn(cfg, impl=impl)


def train_batch_specs(cfg, shape: ShapeConfig):
    """Abstract batch tree + logical axes tree for the train step input."""
    B = shape.global_batch
    i32, f32 = torch.int32, torch.float32
    if isinstance(cfg, TransformerConfig):
        S = shape.seq_len
        ab = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return ab, ax
    if isinstance(cfg, DiTConfig):
        side = shape.img_res // cfg.vae_factor
        lat = (B, side, side, cfg.latent_channels)
        ab = {"latents": _meta(lat, f32), "noise": _meta(lat, f32),
              "t": _meta((B,), i32), "labels": _meta((B,), i32)}
        ax = {"latents": ("batch", None, None, None),
              "noise": ("batch", None, None, None),
              "t": ("batch",), "labels": ("batch",)}
        return ab, ax
    if isinstance(cfg, (ViTConfig, EfficientNetConfig)):
        r = shape.img_res
        ab = {"images": _meta((B, r, r, 3), f32),
              "labels": _meta((B,), i32)}
        ax = {"images": ("batch", "img_h", "img_w", None),
              "labels": ("batch",)}
        return ab, ax
    if isinstance(cfg, DetectorConfig):
        ab = {"canvases": _meta((B, cfg.canvas, cfg.canvas, 3), f32),
              "boxes": _meta((B, 64, 4), f32),
              "valid": _meta((B, 64), torch.bool)}
        ax = {"canvases": ("canvas", None, None, None),
              "boxes": ("canvas", None, None), "valid": ("canvas", None)}
        return ab, ax
    raise TypeError(type(cfg))


def plan_train(cfg, shape: ShapeConfig, mesh, rules: Rules, *,
               opt_cfg: Optional[opt_lib.OptimizerConfig] = None,
               accum_steps: int = 1, impl: str = "xla",
               unroll_loss: bool = False, scale: float = 1.0,
               notes: str = "", grad_rs: bool = False) -> CellPlan:
    opt_cfg = opt_cfg or opt_lib.OptimizerConfig()
    specs = param_specs(cfg)
    ab_params = param_lib.abstract_params(specs)
    ab_opt = opt_lib.abstract_state(ab_params)
    ab_batch, batch_axes = train_batch_specs(cfg, shape)

    p_sh = param_lib.param_pspecs(specs, rules, mesh)
    step = train_state.make_train_step(
        _loss_fn(cfg, rules, impl=impl, unroll_loss=unroll_loss), opt_cfg,
        accum_steps=accum_steps, grad_pspecs=p_sh if grad_rs else None)
    o_sh = _opt_shardings(p_sh)
    b_sh = _shard_tree(mesh, ab_batch, batch_axes, rules)
    return CellPlan(
        arch=cfg.name, shape=shape.name, kind="train", step_fn=step,
        args=(ab_params, ab_opt, ab_batch),
        in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, _metric_shardings()),
        n_params=cfg.n_params, n_active_params=cfg.n_active_params,
        notes=notes or f"accum={accum_steps}", scale=scale, rules=rules)


def plan_prefill(cfg: TransformerConfig, shape: ShapeConfig, mesh,
                 rules: Rules, *, impl: str = "xla") -> CellPlan:
    specs = param_specs(cfg)
    ab_params = param_lib.abstract_params(specs)
    B, S = shape.global_batch, shape.seq_len
    tokens = _meta((B, S), torch.int32)

    def step(params, tokens):
        logits, h = tfm_lib.prefill(cfg, params, tokens, impl=impl)
        return logits

    p_sh = param_lib.param_pspecs(specs, rules, mesh)
    t_sh = divisible_spec((B, S), ("batch", "seq"), rules, mesh)
    out_sh = divisible_spec((B, 1, cfg.vocab), ("batch", None, "vocab"),
                            rules, mesh)
    return CellPlan(cfg.name, shape.name, "prefill", step,
                    (ab_params, tokens), (p_sh, t_sh), out_sh,
                    cfg.n_params, cfg.n_active_params, rules=rules)


def plan_decode(cfg: TransformerConfig, shape: ShapeConfig, mesh,
                rules: Rules) -> CellPlan:
    specs = param_specs(cfg)
    ab_params = param_lib.abstract_params(specs)
    B, S = shape.global_batch, shape.seq_len
    tokens = _meta((B, 1), torch.int32)
    cache = tfm_lib.init_cache(cfg, B, S, "meta")
    cache_ax = tfm_lib.cache_axes(cfg)
    pos = _meta((), torch.int32)

    def step(params, tokens, cache, pos):
        return tfm_lib.decode_step(cfg, params, tokens, cache, pos,
                                   impl="torch")

    p_sh = param_lib.param_pspecs(specs, rules, mesh)
    t_sh = divisible_spec((B, 1), ("decode_batch", None), rules, mesh)
    c_sh = _shard_tree(mesh, cache, cache_ax, rules)
    logits_sh = divisible_spec((B, 1, cfg.vocab),
                               ("decode_batch", None, "vocab"), rules, mesh)
    return CellPlan(cfg.name, shape.name, "decode", step,
                    (ab_params, tokens, cache, pos),
                    (p_sh, t_sh, c_sh, PartitionSpec()),
                    (logits_sh, c_sh),
                    cfg.n_params, cfg.n_active_params,
                    notes=f"kv_cache_len={S}", rules=rules)


def plan_gen(cfg: DiTConfig, shape: ShapeConfig, mesh, rules: Rules, *,
             steps_override: Optional[int] = None, scale: float = 1.0,
             notes: str = "") -> CellPlan:
    specs = param_specs(cfg)
    ab_params = param_lib.abstract_params(specs)
    B = shape.global_batch
    side = shape.img_res // cfg.vae_factor
    noise = _meta((B, side, side, cfg.latent_channels), torch.float32)
    labels = _meta((B,), torch.int32)
    n_steps = steps_override or shape.steps

    def step(params, noise, labels):
        return dit_lib.ddim_sample(cfg, params, noise, labels,
                                   n_steps=n_steps)

    p_sh = param_lib.param_pspecs(specs, rules, mesh)
    n_sh = divisible_spec(noise.shape, ("batch", None, None, None), rules,
                          mesh)
    l_sh = divisible_spec((B,), ("batch",), rules, mesh)
    return CellPlan(cfg.name, shape.name, "gen", step,
                    (ab_params, noise, labels), (p_sh, n_sh, l_sh), n_sh,
                    cfg.n_params, cfg.n_active_params,
                    notes=notes or f"sampler_steps={n_steps}", scale=scale,
                    rules=rules)


def plan_serve(cfg, shape: ShapeConfig, mesh, rules: Rules) -> CellPlan:
    specs = param_specs(cfg)
    ab_params = param_lib.abstract_params(specs)
    B, r = shape.global_batch, shape.img_res
    if isinstance(cfg, DetectorConfig):
        images = _meta((B, cfg.canvas, cfg.canvas, 3), torch.float32)
        step = detector_lib.serve_fn(cfg)
        out_sh = None
    else:
        images = _meta((B, r, r, 3), torch.float32)
        mod = _model_module(cfg)

        def step(p, x):
            return mod.serve(cfg, p, x)
        out_sh = divisible_spec((B, cfg.n_classes), ("batch", "vocab"),
                                rules, mesh)
    p_sh = param_lib.param_pspecs(specs, rules, mesh)
    i_sh = divisible_spec(images.shape, ("batch", "img_h", "img_w", None),
                          rules, mesh)
    return CellPlan(cfg.name, shape.name, "serve", step,
                    (ab_params, images), (p_sh, i_sh), out_sh,
                    cfg.n_params, cfg.n_active_params, rules=rules)


CHUNKED_SEQ = 2048       # LM seq length at/above which the chunked
                         # (flash-equivalent) attention replaces naive


def plan_cell(cfg, shape: ShapeConfig, mesh, rules: Rules, *,
              accum_steps: int = 1,
              opt_cfg: Optional[opt_lib.OptimizerConfig] = None,
              dryrun: bool = False,
              depth_override: Optional[int] = None,
              grad_rs: bool = False) -> CellPlan:
    """Plan a cell.

    Exec mode (default): the production program — chunked
    (flash-equivalent) attention for LM cells with seq >= CHUNKED_SEQ,
    microbatch accumulation as configured.

    Unit mode (``dryrun=True``): one *repeated unit* — ``depth_override``
    layers, one microbatch, one sampler step — with ``scale`` = units per
    full step.  The JAX dry run needs it because XLA's cost analysis
    counts a scanned layer once; the port runs every layer eagerly and
    counts it (``launch/dryrun.py`` counts the full program directly), so
    unit mode serves the check that the JAX secant over depths 1 and 2
    gives the direct count.
    """
    if dryrun and depth_override is not None and hasattr(cfg, "n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=depth_override)

    lm_seq = shape.seq_len if isinstance(cfg, TransformerConfig) else 0

    if shape.kind in ("train", "cls"):
        impl = "chunked" if lm_seq >= CHUNKED_SEQ else "xla"
        if dryrun and accum_steps > 1:
            micro = dataclasses.replace(
                shape, global_batch=shape.global_batch // accum_steps)
            return plan_train(
                cfg, micro, mesh, rules, opt_cfg=opt_cfg, accum_steps=1,
                impl=impl, unroll_loss=dryrun, scale=float(accum_steps),
                notes=f"unit=microbatch({micro.global_batch}) "
                      f"x{accum_steps}; optimizer counted per unit",
                grad_rs=grad_rs)
        return plan_train(cfg, shape, mesh, rules, opt_cfg=opt_cfg,
                          accum_steps=accum_steps, impl=impl,
                          unroll_loss=dryrun, grad_rs=grad_rs)
    if shape.kind == "prefill":
        impl = "chunked" if lm_seq >= CHUNKED_SEQ else "xla"
        return plan_prefill(cfg, shape, mesh, rules, impl=impl)
    if shape.kind == "decode":
        return plan_decode(cfg, shape, mesh, rules)
    if shape.kind == "gen":
        if dryrun and shape.steps > 1:
            return plan_gen(cfg, shape, mesh, rules, steps_override=1,
                            scale=float(shape.steps),
                            notes=f"unit=1 sampler step x{shape.steps}")
        return plan_gen(cfg, shape, mesh, rules)
    if shape.kind == "serve":
        return plan_serve(cfg, shape, mesh, rules)
    raise ValueError(shape.kind)


# ------------------------------------------------------------ the run ----

def _to_dtensor(x: torch.Tensor, spec, mesh, dm):
    local = torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype,
                        device="meta")
    return DTensor.from_local(local, dm, placements(spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride())


def _lay_out(tree, specs, mesh, dm):
    if isinstance(tree, dict):
        return {k: _lay_out(v, specs[k], mesh, dm) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lay_out(v, s, mesh, dm) for v, s in zip(tree, specs)]
    return _to_dtensor(tree, specs, mesh, dm)


def abstract_args(plan: CellPlan, mesh) -> tuple:
    """The plan's arguments as DTensors of ``meta`` tensors, each laid out
    by its spec in ``plan.in_shardings`` on the mesh's DeviceMesh."""
    dm = shardingx.device_mesh(mesh)
    return tuple(_lay_out(a, s, mesh, dm)
                 for a, s in zip(plan.args, plan.in_shardings))


def run_abstract(plan: CellPlan, mesh, args: Optional[tuple] = None):
    """Run the planned step on the abstract mesh: DTensors of ``meta``
    tensors (:func:`abstract_args`), under ``use_mesh`` with the plan's
    rules and ``implicit_replication``.  Returns the step's outputs (meta
    DTensors); allocates nothing.  This is the port's ``lower_cell``."""
    if args is None:
        args = abstract_args(plan, mesh)
    with shardingx.use_mesh(mesh, plan.rules), implicit_replication():
        return plan.step_fn(*args)
