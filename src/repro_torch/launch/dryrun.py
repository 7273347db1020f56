"""Multi-pod dry run: plan every (arch x shape) cell on the production
meshes, run its step on the ``meta`` device and read the roofline terms.

Port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and compiles
each cell for 512 placeholder host devices (it sets ``XLA_FLAGS`` at
import); the port sets nothing at import.  It lays each cell's arguments
out as DTensors of ``meta`` tensors over a fake process group of 512 ranks
(``compat.shardingx.device_mesh``, started on first use) and runs the
step eagerly (``api.run_abstract``) under :class:`StepCounter`, which
counts every op each device would run: nothing is allocated and nothing
runs on a card.

XLA's cost analysis counts a scanned layer once, so the JAX dry run takes
a secant over unit programs of depths 1 and 2.  The eager run counts
every layer, so the port counts the full program directly (notes:
``direct``); without ``--quick`` it also takes the secant over depths 1
and 2 and reports in the notes how far it lands from the direct count.
``--all`` counts its cells in one worker process a host CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vit-b16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --quick
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh test --quick \\
      --arch vit-s16 --shape serve_b128
  PYTHONPATH=src python -m repro_torch.launch.dryrun --quick --depth 2 \\
      --arch mistral-large-123b --shape train_4k

``--depth`` cuts every model to that many layers (:func:`cut_depth`):
each op of a cell still plans and counts, in a fraction of the time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

from repro_torch import api
from repro_torch import configs as cfg_registry
from repro_torch.config import HardwareConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_chips)
from repro_torch.sharding import ShardingConfig


def input_specs(arch_id: str, shape_name: str = None):
    """``meta`` stand-ins for every model input of the arch's cells:
    {shape_name: args tuple} (nothing allocated)."""
    spec = cfg_registry.arch_spec(arch_id)
    mesh = make_test_mesh()
    out = {}
    for shape in spec.shapes:
        if shape_name and shape.name != shape_name:
            continue
        ov = spec.override(shape.name)
        rules = ShardingConfig.make(fsdp=ov.fsdp,
                                    sequence_parallel=ov.sequence_parallel).rules
        plan = api.plan_cell(spec.model, shape, mesh, rules,
                             accum_steps=ov.accum_steps)
        out[shape.name] = plan.args
    return out


def count_metrics(plan, mesh) -> dict:
    """Run the plan's step on the mesh under :class:`StepCounter`."""
    args = api.abstract_args(plan, mesh)
    with hlo_analysis.StepCounter() as c:
        out = api.run_abstract(plan, mesh, args)
    return {
        "flops": float(c.flops),
        "bytes": float(c.bytes),
        "coll": c.coll.total_bytes,
        "coll_by_kind": c.coll.bytes_by_kind,
        "coll_count": c.coll.total_count,
        "args": hlo_analysis.local_bytes(args),
        "temp": 0,
        "out": hlo_analysis.local_bytes(out),
    }


def run_cell(arch_id: str, shape, mesh, mesh_name: str, hw: HardwareConfig,
             verbose: bool = True, rules_override=None, accum_override=None,
             model_override=None, quick: bool = False,
             grad_rs: bool = False):
    """One counted run of the full program per cell (``direct``); without
    ``quick`` two more at depths 1 and 2 whose secant over depth (R + L*B
    with B = m2 - m1, R = m1 - B, times the unit scale) is set beside the
    direct count in the notes.
    """
    spec = cfg_registry.arch_spec(arch_id)
    model = model_override if model_override is not None else spec.model
    ov = spec.override(shape.name)
    rules = rules_override if rules_override is not None else \
        ShardingConfig.make(fsdp=ov.fsdp,
                            sequence_parallel=ov.sequence_parallel,
                            act_seq=ov.act_seq,
                            extra=ov.extra_rules).rules
    if ov.remat_policy and hasattr(model, "remat_policy"):
        model = dataclasses.replace(model, remat_policy=ov.remat_policy)
    if ov.quant_weights and hasattr(model, "quant_weights"):
        model = dataclasses.replace(model, quant_weights=True)
    accum = accum_override or ov.accum_steps

    t0 = time.time()
    full_plan = api.plan_cell(model, shape, mesh, rules, accum_steps=accum,
                              grad_rs=grad_rs)
    full = count_metrics(full_plan, mesh)
    flops, by, coll = full["flops"], full["bytes"], full["coll"]
    method = "direct"
    runs = 1
    if not quick and hasattr(model, "n_layers") and model.n_layers > 1:
        units = []
        for depth in (1, 2):
            plan = api.plan_cell(model, shape, mesh, rules,
                                 accum_steps=accum, dryrun=True,
                                 depth_override=depth, grad_rs=grad_rs)
            units.append((count_metrics(plan, mesh), plan.scale))
        (u1, scale), (u2, _) = units
        L = model.n_layers
        secant = (u1["flops"] + (L - 1) * (u2["flops"] - u1["flops"])) \
            * scale
        method = (f"direct; secant(L={L}, scale={scale:g}) flops "
                  f"{secant / max(flops, 1):.4f}x direct")
        runs = 3
    run_s = time.time() - t0

    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    data_size = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
    terms = hlo_analysis.RooflineTerms(
        arch=arch_id, shape=shape.name, mesh=mesh_name,
        flops_per_device=flops,
        bytes_per_device=by,
        collective_bytes_per_device=coll,
        peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, nvlink_bw=hw.nvlink_bw,
        model_flops_global=hlo_analysis.model_flops(
            full_plan.n_params, full_plan.n_active_params, shape,
            full_plan.kind, model),
        chips=mesh_chips(mesh),
        arg_bytes=full["args"],
        temp_bytes=full["temp"],
        out_bytes=full["out"],
        analytic_act_bytes=hlo_analysis.estimate_activation_bytes(
            model, shape, full_plan.kind, data_size,
            axis_sizes.get("model", 1), accum, act_seq=ov.act_seq),
        notes=f"{full_plan.notes}; {method}")
    coll_by_kind = full["coll_by_kind"]
    coll_count = full["coll_count"]

    if verbose:
        print(f"== {arch_id} x {shape.name} on {mesh_name} "
              f"({runs} meta runs, {run_s:.1f}s) ==")
        print(f"  memory/dev: args={terms.arg_bytes/2**30:.3f}GiB "
              f"analytic_act={terms.analytic_act_bytes/2**30:.3f}GiB "
              f"HBM {hw.hbm_bytes/2**30:.0f}GiB [{terms.notes}]")
        print(f"  per-step totals/dev: flops={terms.flops_per_device:.3e} "
              f"bytes={terms.bytes_per_device:.3e} "
              f"collective={terms.collective_bytes_per_device:.3e}B")
        print(f"  schedule (full program): "
              f"{coll_count} collective ops "
              f"{ {k: f'{v:.2e}' for k, v in coll_by_kind.items() if v} }")
        print(f"  roofline: t_comp={terms.t_compute:.3e}s "
              f"t_mem={terms.t_memory:.3e}s t_coll={terms.t_collective:.3e}s "
              f"-> {terms.bottleneck}-bound, "
              f"useful_flops={terms.useful_flops_ratio:.2f}, "
              f"frac={terms.roofline_fraction:.2f}")
    fits = terms.hbm_estimate <= hw.hbm_bytes
    if verbose and not fits:
        print("  !! estimated footprint exceeds per-device HBM")
    return terms, run_s, fits


def _row(terms, run_s, fits) -> dict:
    row = terms.row()
    row.update(compile_s=round(run_s, 1), fits_hbm=fits,
               flops_per_device=terms.flops_per_device,
               bytes_per_device=terms.bytes_per_device,
               collective_bytes_per_device=terms.collective_bytes_per_device,
               arg_bytes=terms.arg_bytes,
               temp_bytes=terms.temp_bytes,
               analytic_act_bytes=terms.analytic_act_bytes,
               hbm_estimate=terms.hbm_estimate,
               model_flops_global=terms.model_flops_global,
               chips=terms.chips)
    return row


def _meshes(kind: str, multi_pod: bool, both: bool):
    make = make_production_mesh if kind == "production" else make_test_mesh
    if both:
        meshes = [(make(multi_pod=False), "16x16"),
                  (make(multi_pod=True), "2x16x16")]
    else:
        meshes = [(make(multi_pod=multi_pod),
                   "2x16x16" if multi_pod else "16x16")]
    if kind == "test":
        meshes = [(m, n + "-test") for m, n in meshes]
    return meshes


def _quiet():
    """DTensor logs a warning at every multi-dim reduction it splits into
    sequential all-reduces (the counts carry them already), and warns at
    every one-element tensor it takes as replicated (the MoE's capacity-1
    slot index in decode)."""
    import logging
    import warnings
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore", message="Found a non-scalar tensor")


def cut_depth(model, depth: int):
    """``model`` cut to ``depth`` layers (an EfficientNet to at most
    ``depth`` blocks a stage), every width, microbatch and sampler step
    as it is: each op of the cell still plans and counts, in a fraction
    of the time."""
    if hasattr(model, "n_layers"):
        return dataclasses.replace(model,
                                   n_layers=min(model.n_layers, depth))
    most = max(stage[2] for stage in model.STAGES)
    return dataclasses.replace(model,
                               depth_mult=min(model.depth_mult, depth / most))


def _job(arch_id: str, shape_name: str, mesh_kind: str, multi_pod: bool,
         mesh_name: str, quick: bool, depth: Optional[int] = None):
    """One cell in a worker process, its model cut to ``depth`` layers
    when given (:func:`cut_depth`): (row or None, printed text, failure
    or None)."""
    import contextlib
    import io
    buf = io.StringIO()
    _quiet()
    mesh = _meshes(mesh_kind, multi_pod, False)[0][0]
    spec = cfg_registry.arch_spec(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    model = cut_depth(spec.model, depth) if depth else None
    try:
        with contextlib.redirect_stdout(buf):
            terms, run_s, fits = run_cell(arch_id, shape, mesh, mesh_name,
                                          HardwareConfig(),
                                          model_override=model, quick=quick)
        return _row(terms, run_s, fits), buf.getvalue(), None
    except Exception as e:  # a failing cell is a bug in the system
        return (None, buf.getvalue() + traceback.format_exc(),
                (arch_id, shape_name, mesh_name, repr(e)))


def _units(job) -> int:
    """A cell's rough op count: layers (an EfficientNet's blocks), as the
    job cuts them, x the times its step runs them (microbatches, forward
    and backward; sampler steps)."""
    arch_id, shape_name = job[0], job[1]
    spec = cfg_registry.arch_spec(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    model = (cut_depth(spec.model, job[6]) if len(job) > 6 and job[6]
             else spec.model)
    depth = getattr(model, "n_layers", None) or sum(
        model.scaled_repeats(stage[2]) for stage in model.STAGES)
    if shape.is_train:
        return depth * 3 * spec.override(shape_name).accum_steps
    return depth * (shape.steps if shape.kind == "gen" else 1)


def run_jobs(jobs, n_jobs: Optional[int] = None, echo: bool = False):
    """Count each cell of ``jobs`` (``(arch, shape, mesh kind, multi_pod,
    mesh name, quick[, depth])``), ``n_jobs`` at once (default: one a CPU
    of this process's affinity) in spawned worker processes (each starts
    its own fake process group; the longest cells are handed out first);
    with ``echo`` each cell's lines are printed, in the cells' order.
    Returns (JSON rows, failures)."""
    if n_jobs is None:
        n_jobs = len(os.sched_getaffinity(0))
    if n_jobs > 1 and len(jobs) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(
                max_workers=min(n_jobs, len(jobs)),
                mp_context=mp.get_context("spawn")) as ex:
            # the longest cells first, so that none is left to run alone
            order = sorted(range(len(jobs)), key=lambda i: -_units(jobs[i]))
            futures = {i: ex.submit(_job, *jobs[i]) for i in order}
            cells = [futures[i].result() for i in range(len(jobs))]
    else:
        cells = (_job(*job) for job in jobs)
    done = []
    for cell in cells:
        done.append(cell)
        if echo:
            print(cell[1], end="", flush=True)
    results = [row for row, _, _ in done if row is not None]
    failures = [f for _, _, f in done if f is not None]
    return results, failures


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=cfg_registry.ARCH_IDS)
    p.add_argument("--shape")
    p.add_argument("--all", action="store_true", help="all 40 pool cells")
    p.add_argument("--multi-pod", action="store_true",
                   help="2x16x16 (512 devices) instead of 16x16")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--mesh", choices=("production", "test"),
                   default="production")
    p.add_argument("--json", help="write results JSON here")
    p.add_argument("--quick", action="store_true",
                   help="the direct count only (skip the secant runs at "
                        "depths 1 and 2)")
    p.add_argument("--depth", type=int,
                   help="cut every model to this many layers (cut_depth)")
    args = p.parse_args(argv)
    _quiet()

    meshes = _meshes(args.mesh, args.multi_pod, args.both_meshes)
    if args.all:
        cells = list(cfg_registry.all_cells())
    elif args.arch:
        spec = cfg_registry.arch_spec(args.arch)
        cells = [(args.arch, s) for s in spec.shapes
                 if not args.shape or s.name == args.shape]
    else:
        p.error("--arch or --all required")

    jobs = [(arch_id, shape.name, args.mesh,
             multi if args.both_meshes else args.multi_pod, mesh_name,
             args.quick, args.depth)
            for multi, (mesh, mesh_name) in zip((False, True), meshes)
            for arch_id, shape in cells]
    results, failures = run_jobs(jobs, None if args.all else 1, echo=True)

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"results": results,
                       "failures": failures}, f, indent=1)
        print(f"wrote {args.json}")

    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
