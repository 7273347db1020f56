"""Perf hillclimb driver: named variants per chosen cell, planned and
counted on the production mesh, and a tile search for the Hopper K4;
results accumulate in ``build/hillclimb.json``.

Port of ``repro/launch/hillclimb.py``, with its cells, variants and
functions by name.  The JAX module sets ``XLA_FLAGS`` at import (512 host
devices); this one sets nothing at import and starts no process group: a
variant runs through the port's dry run (``dryrun.run_cell``), whose
abstract meshes start torch's fake process group on first use.  Every
``t_*`` of a variant's row is the port's meta-device program priced on
:class:`HardwareConfig`, the H100's data sheet: a reading of the plan, not
a measurement.

``kernel_blocks`` is the block search.  The JAX cell times the fused
stitch->embed Pallas kernel's ``block_rows`` (patch rows an MXU dispatch)
in interpret mode; that chunking has no counterpart in the Hopper kernel,
whose block is a tile of (tokens, columns of d).  So the port times the
bf16 K4 once for each tile of ``fused_embed.K4_TILES`` on the card, and
holds each tile's output against the default tile's (bit for bit) and
against the plain version.  It times the hand kernel, so it raises on a
CPU tensor.  The JAX module writes ``out/hillclimb.json``; the port
writes its own, git-ignored file.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell mistral_decode
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all --quick --depth 2
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell kernel_blocks
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import sys
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfg_registry
from repro_torch.config import HardwareConfig
from repro_torch.kernels.stitch.fused_embed import K4_TILES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import ShardingConfig

OUT = "build/hillclimb.json"


def _shape(arch_id, name):
    return [s for s in cfg_registry.arch_spec(arch_id).shapes
            if s.name == name][0]


def _moe_group(model, group):
    return dataclasses.replace(
        model, moe=dataclasses.replace(model.moe, group_size=group))


# variant -> kwargs for run_cell (model_override built lazily)
CELLS = {
    "llama4_train": {
        "arch": "llama4-scout-17b-a16e", "shape": "train_4k",
        "variants": {
            "base": {},
            "v1_grad_rs": {"grad_rs": True},
            "v2_accum4": {"accum_override": 4},
            "v3_moe_group2048": {"model_fn": lambda m: _moe_group(m, 2048)},
            "v4_rs_accum4": {"grad_rs": True, "accum_override": 4},
            "v5_rs_accum4_group2048": {
                "grad_rs": True, "accum_override": 4,
                "model_fn": lambda m: _moe_group(m, 2048)},
            "v6_accum1": {"accum_override": -1},     # -1 -> accum 1
            "v7_accum1_group128": {
                "accum_override": -1,
                "model_fn": lambda m: _moe_group(m, 128)},
            "v8_accum4_group128_noactseq": {
                "accum_override": 4,
                "model_fn": lambda m: _moe_group(m, 128),
                "rules": {"act_seq": False}},
            "v9_accum2_group128": {
                "accum_override": 2,
                "model_fn": lambda m: _moe_group(m, 128)},
        },
    },
    "mistral_decode": {
        "arch": "mistral-large-123b", "shape": "decode_32k",
        "variants": {
            "base_dus": {"model_fn": lambda m: dataclasses.replace(
                m, cache_update="dus")},
            "v1_masked_update": {"model_fn": lambda m: dataclasses.replace(
                m, cache_update="masked")},
            "v2_masked_fused_qkv": {"model_fn": lambda m: dataclasses.replace(
                m, cache_update="masked", fused_qkv=True)},
            "v3_int8_resident": {
                "model_fn": lambda m: dataclasses.replace(
                    m, cache_update="masked", quant_weights=True),
                "rules": {"fsdp": False, "sequence_parallel": True}},
            "v4_int8_weights_and_kv": {
                "model_fn": lambda m: dataclasses.replace(
                    m, cache_update="masked", quant_weights=True,
                    quant_kv=True),
                "rules": {"fsdp": False, "sequence_parallel": True}},
        },
    },
    "dit_gen": {
        "arch": "dit-xl2", "shape": "gen_1024",
        "variants": {
            "base": {},
            "v1_token_cp": {"rules": {"extra": {"seq": "data"}}},
        },
    },
    "vit_serve": {
        "arch": "vit-b16", "shape": "serve_b128",
        "variants": {
            "base": {},
            "v1_fused_qkv": {"model_fn": lambda m: dataclasses.replace(
                m, fused_qkv=True)},
            "v2_conv_patch": {"model_fn": lambda m: dataclasses.replace(
                m, patch_embed="conv")},
            "v3_fused_conv": {"model_fn": lambda m: dataclasses.replace(
                m, fused_qkv=True, patch_embed="conv")},
            "v4_head_dim_tp": {
                "rules": {"extra": {"heads": None, "kv_heads": None,
                                    "head_dim": "model"}}},
            "v5_spatial_stem": {
                "model_fn": lambda m: dataclasses.replace(
                    m, patch_embed="conv"),
                "rules": {"extra": {"img_h": "model"}}},
        },
    },
}


def variant_kwargs(cell_name: str, variant: str,
                   depth: Optional[int] = None) -> dict:
    """The ``run_cell`` keywords of a variant, as the JAX ``run_variant``
    builds them: ``model_override`` (the variant's model with the cell's
    remat policy; None for the arch's own), ``rules_override`` (the
    cell's rule table with the variant's overlay; absent where the
    variant has none), ``accum_override`` (-1 is 1) and ``grad_rs``.
    ``depth`` cuts the model to that many layers (``dryrun.cut_depth``)."""
    cell = CELLS[cell_name]
    spec = cfg_registry.arch_spec(cell["arch"])
    kw = dict(cell["variants"][variant])
    model_fn = kw.pop("model_fn", None)
    model = model_fn(spec.model) if model_fn else None
    ov = spec.override(cell["shape"])
    rules_kw = kw.pop("rules", None)
    if rules_kw is not None:
        base_kw = dict(fsdp=ov.fsdp, sequence_parallel=ov.sequence_parallel,
                       act_seq=ov.act_seq, extra=ov.extra_rules)
        base_kw.update(rules_kw)
        kw["rules_override"] = ShardingConfig.make(**base_kw).rules
    if kw.get("accum_override") == -1:
        kw["accum_override"] = 1
    # the cell's remat override, exactly as the baseline dry run applies it
    if ov.remat_policy and model is not None and hasattr(model,
                                                         "remat_policy"):
        model = dataclasses.replace(model, remat_policy=ov.remat_policy)
    if depth:
        model = dryrun.cut_depth(model or spec.model, depth)
    kw["model_override"] = model
    return kw


def run_variant(cell_name: str, variant: str, mesh, hw, *,
                depth: Optional[int] = None, quick: bool = False):
    """One variant planned and counted on ``mesh``; its row.  ``depth``
    cuts the model (:func:`variant_kwargs`); ``quick`` skips the secant
    runs (``dryrun.run_cell``)."""
    cell = CELLS[cell_name]
    shape = _shape(cell["arch"], cell["shape"])
    kw = variant_kwargs(cell_name, variant, depth)
    terms, compile_s, fits = dryrun.run_cell(
        cell["arch"], shape, mesh, "16x16", hw, verbose=False,
        quick=quick, **kw)
    row = {
        "cell": cell_name, "variant": variant,
        "t_compute": terms.t_compute, "t_memory": terms.t_memory,
        "t_collective": terms.t_collective,
        "bottleneck": terms.bottleneck,
        "useful": terms.useful_flops_ratio,
        "frac": terms.roofline_fraction,
        "hbm_gib": terms.hbm_estimate / 2**30,
        "fits": fits, "compile_s": compile_s,
        "depth": depth,
    }
    print(f"{cell_name:16s} {variant:24s} "
          f"t_comp={row['t_compute']:.3e} t_mem={row['t_memory']:.3e} "
          f"t_coll={row['t_collective']:.3e} [{row['bottleneck']}] "
          f"frac={row['frac']:.3f} fits={fits}")
    return row


# ------------------------------------------------------ detector_stitch ----

def stitch_window(patch_pixels: torch.Tensor, records: torch.Tensor,
                  m: int, n: int) -> torch.Tensor:
    """The JAX package's stitch oracle (``repro/kernels/stitch/ref.py``)
    with shapes that do not depend on the records' values, so that it runs
    on ``meta`` tensors (the port's ``stitch_reference`` copies a slice a
    valid record, read on the host).  As the oracle does, each record's
    slot window (Hmax x Wmax) is clamped inside its canvas and the patch
    shifted to its place in it; here every record's masked window is
    gathered at once and summed into zero canvases by one accumulating
    scatter.  Placements never overlap, so each canvas pixel gets at most
    one patch value: on the packer's records it gives
    ``stitch_reference``'s canvases."""
    p, hmax, wmax, c = patch_pixels.shape
    b, k, _ = records.shape
    dev = patch_pixels.device
    valid, slot, x, y, w, h = records.reshape(b * k, 6).unbind(1)
    rows = torch.arange(hmax, device=dev)
    cols = torch.arange(wmax, device=dev)
    ys, xs = y.clamp(0, m - hmax), x.clamp(0, n - wmax)
    dy, dx = (y - ys)[:, None], (x - xs)[:, None]
    inside_r = (rows >= dy) & (rows < dy + h[:, None])          # (R, Hmax)
    inside_c = (cols >= dx) & (cols < dx + w[:, None])          # (R, Wmax)
    mask = (inside_r[:, :, None] & inside_c[:, None, :]
            & (valid > 0)[:, None, None])
    src_r = (rows - dy) % hmax
    src_c = (cols - dx) % wmax
    rec = torch.arange(b * k, device=dev)[:, None, None]
    img = patch_pixels.index_select(0, slot.clamp(0, p - 1))
    vals = torch.where(mask[..., None],
                       img[rec, src_r[:, :, None], src_c[:, None, :]],
                       torch.zeros((), dtype=patch_pixels.dtype, device=dev))
    canvas = torch.arange(b, device=dev).repeat_interleave(k)
    out = torch.zeros((b, m, n, c), dtype=patch_pixels.dtype, device=dev)
    return out.index_put_(
        (canvas[:, None, None], (ys[:, None] + rows)[:, :, None],
         (xs[:, None] + cols)[:, None, :]), vals, accumulate=True)


def _stitch_step(model, m: int):
    """``step(params, slots, records)``: :func:`stitch_window` on each
    device's whole slot array (a DTensor's slots are gathered first; the
    JAX program's dynamic slot index on the sharded axis gathers them
    too), the canvases laid out as the base cell's images, then the
    detector's serve."""
    from repro_torch.models import detector as det
    from repro_torch.sharding import (is_dtensor, per_device,
                                      with_logical_constraint)

    def step(params, slots, records):
        if is_dtensor(slots):
            from torch.distributed.tensor import Replicate
            rep = [Replicate()] * slots.device_mesh.ndim
            canvases = per_device(lambda s, r: stitch_window(s, r, m, m),
                                  rep, (rep, rep), slots.device_mesh)(
                                      slots, records)
        else:
            canvases = stitch_window(slots, records, m, m)
        canvases = with_logical_constraint(
            canvases, ("batch", "img_h", "img_w", None))
        return det.serve(model, params, canvases)
    return step


def run_detector_stitch(mesh, hw, *, depth: Optional[int] = None):
    """Tangram serving with device-side stitching.

    base: the serverless function receives pre-assembled canvases
          (B, 1024, 1024, 3) — the paper's host-assembly model.
    v1:   the function receives compact patch slots (P, 256, 256, 3) +
          records and assembles canvases on the device (the stitch oracle
          :func:`stitch_window` here, as the JAX cell counts its jnp
          oracle).  At the measured 0.65 mean canvas efficiency the input
          bytes drop ~35 %.

    Both are counted on ``meta`` tensors (``dryrun.count_metrics``), the
    slots sharded on ``canvas`` and the records replicated.  ``depth``
    cuts the detector's trunk (``dryrun.cut_depth``)."""
    from repro_torch import api
    from repro_torch import param as param_lib
    from repro_torch.sharding import PartitionSpec, divisible_spec

    spec = cfg_registry.arch_spec("tangram-detector")
    model = spec.model if not depth else dryrun.cut_depth(spec.model, depth)
    shape = _shape("tangram-detector", "serve_c8")
    rules = ShardingConfig.make().rules
    rows = []

    base_plan = api.plan_cell(model, shape, mesh, rules)
    base = dryrun.count_metrics(base_plan, mesh)

    B, M = shape.global_batch, model.canvas
    P, K, slot = 84, 12, 256            # 0.65 efficiency worth of slots
    specs = api.param_specs(model)
    slots = torch.empty((P, slot, slot, 3), dtype=torch.float32,
                        device="meta")
    records = torch.empty((B, K, 6), dtype=torch.int32, device="meta")
    plan = api.CellPlan(
        model.name, "serve_c8_slots", "serve", _stitch_step(model, M),
        (param_lib.abstract_params(specs), slots, records),
        (param_lib.param_pspecs(specs, rules, mesh),
         divisible_spec(slots.shape, ("canvas", None, None, None), rules,
                        mesh), PartitionSpec()),
        None, model.n_params, model.n_active_params, rules=rules)
    v1 = dryrun.count_metrics(plan, mesh)

    canvas_in = B * M * M * 3 * 4
    slot_in = P * slot * slot * 3 * 4
    for name, m_ in (("base_host_assembled", base),
                     ("v1_device_stitch", v1)):
        rows.append({"cell": "detector_stitch", "variant": name,
                     "t_memory": m_["bytes"] / hw.hbm_bw,
                     "arg_bytes": m_["args"], "bytes": m_["bytes"],
                     "flops": m_["flops"], "coll": m_["coll"],
                     "depth": depth})
        print(f"detector_stitch  {name:24s} bytes/dev={m_['bytes']:.3e} "
              f"args={m_['args']/2**20:.0f}MiB")
    print(f"  input bytes: canvases {canvas_in/2**20:.0f} MiB vs slots "
          f"{slot_in/2**20:.0f} MiB ({100*(1-slot_in/canvas_in):.0f}% less "
          f"host->device traffic)")
    return rows


# --------------------------------------------------------- kernel_blocks ----

#: the tiles of the bf16 K4 (``fused_embed.K4_TILES``), the port's
#: counterpart of the JAX ``block_rows`` candidates
KERNEL_BLOCK_CANDIDATES = K4_TILES
#: the bf16 K4's tolerance against its plain version (atol = rtol), as
#: ``chip_smoke.py`` phase 3b and the card tests hold it
K4_TOL = 2e-2


def pick_tile(m: int, n: int, patch: int, d: int, default=None,
              out: Optional[str] = None):
    """The fastest bf16 K4 tile (by ``ms_device``) for this geometry from a
    prior ``--cell kernel_blocks`` run (cached in :data:`OUT`, or
    ``out``); ``default`` when the cell never ran for it.  Nothing on the
    main path calls it (as the JAX ``pick_block_rows``): the main path
    launches the default tile."""
    try:
        with open(out or OUT) as f:
            rows = json.load(f)
    except (OSError, ValueError):
        return default
    best = None
    for r in rows:
        if (r.get("cell") == "kernel_blocks" and r.get("m") == m
                and r.get("n") == n and r.get("patch") == patch
                and r.get("d_model") == d):
            if best is None or r["ms_device"] < best["ms_device"]:
                best = r
    return tuple(best["tile"]) if best else default


def _graph_ms(fn, iters: int = 20, windows: int = 3) -> float:
    """Device time of one call: ``iters`` calls in one CUDA graph, its
    replay between two CUDA events over ``iters``; the median of
    ``windows`` replays."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


def run_kernel_blocks(m: int = 128, n: int = 128, patch: int = 32,
                      d_model: int = 64, smoke: bool = False,
                      device=None):
    """Tile search for the bf16 K4 (stitch->embed) on the card.

    Builds the JAX cell's plan (12 random patches from rng 7, packed by
    ``build_batch_plan``, crops from numpy, weights * 0.05, zero bias),
    then for each tile of :data:`KERNEL_BLOCK_CANDIDATES`: the call timed
    by ``core.latency.measure`` (``mu_s`` / ``sigma_s``, host clock around
    a synchronised call, as the JAX cell), the device time of a CUDA graph
    of the call (``ms_device``), the largest difference from the plain
    version on the same inputs (``max_abs_err``; ``close``: within
    :data:`K4_TOL`) and whether its output equals the default tile's bit
    for bit.  Raises on the CPU: it times the hand kernel, and a plain
    version has no tile."""
    from repro_torch.core.latency import measure
    from repro_torch.core.partitioning import Patch
    from repro_torch.core.stitching import build_batch_plan, stitch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.stitch import ops as stitch_ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"run_kernel_blocks times the hand-written K4 on "
                         f"a card; got device {dev} (the plain version "
                         f"has no tile)")
    rng = np.random.default_rng(7)
    patches = [Patch(0, 0, int(rng.integers(patch, n // 2 + 1)),
                     int(rng.integers(patch, m // 2 + 1)))
               for _ in range(12)]
    plan = build_batch_plan(patches, stitch(patches, m, n), m, n)
    crops = [np.asarray(rng.normal(size=(p.h, p.w, 3)), np.float32)
             for p in patches]
    slots = torch.from_numpy(stitch_ops.pack_plan_host(crops, plan)).to(dev)
    records = torch.from_numpy(plan.records).to(dev)
    kern = (torch.from_numpy(np.asarray(
        rng.normal(size=(patch * patch * 3, d_model)), np.float32)) * 0.05
    ).to(device=dev, dtype=torch.bfloat16)
    bias = torch.zeros((d_model,), dtype=torch.bfloat16, device=dev)

    def call(tile):
        return stitch_ops.stitch_embed(slots, records, kern, bias, m, n,
                                       patch, tile=tile)
    plain = stitch_ops.stitch_embed(slots, records, kern, bias, m, n, patch,
                                    impl="torch").float()
    default = call(None)
    rows = []
    iters = 2 if smoke else 8
    name = torch.cuda.get_device_name(dev)
    for tile in KERNEL_BLOCK_CANDIDATES:
        got = call(tile)
        torch.cuda.synchronize(dev)
        tbl = measure(lambda b, _t=tile: call(_t),
                      batch_sizes=(plan.num_canvases,), iters=iters,
                      warmup=1, sync=torch.cuda.synchronize)
        mu, sigma = tbl.table[plan.num_canvases]
        ms = _graph_ms(lambda _t=tile: call(_t), iters=iters)
        row = {"cell": "kernel_blocks", "variant": f"tile{tile[0]}x{tile[1]}",
               "m": m, "n": n, "patch": patch, "d_model": d_model,
               "tile": list(tile), "canvases": plan.num_canvases,
               "mu_s": mu, "sigma_s": sigma, "ms_device": ms,
               "max_abs_err": float((got.float() - plain).abs().max()),
               "close": bool(torch.allclose(got.float(), plain, atol=K4_TOL,
                                            rtol=K4_TOL)),
               "bit_equal_default": bool(torch.equal(got, default)),
               "device": name}
        rows.append(row)
        print(f"kernel_blocks    {row['variant']:<11s} mu={mu:.6f}s "
              f"sigma={sigma:.6f}s device={ms:.4f}ms "
              f"err={row['max_abs_err']:.3g} "
              f"{'close' if row['close'] else 'FAR'} "
              f"{'bit-equal' if row['bit_equal_default'] else 'DIFFERS'} "
              f"(B={plan.num_canvases}, {m}x{n}/p{patch}, d {d_model})",
              flush=True)
    return rows


# ------------------------------------------------------------------ jobs ----

def _job(cell: str, variant: Optional[str], quick: bool,
         depth: Optional[int]):
    """One variant (or ``detector_stitch``'s pair, ``variant`` None) on
    the production mesh in a worker process: (rows, printed text, failure
    or None)."""
    dryrun._quiet()
    buf = io.StringIO()
    mesh = make_production_mesh()
    try:
        with contextlib.redirect_stdout(buf):
            if cell == "detector_stitch":
                rows = run_detector_stitch(mesh, HardwareConfig(),
                                           depth=depth)
            else:
                rows = [run_variant(cell, variant, mesh, HardwareConfig(),
                                    depth=depth, quick=quick)]
        return rows, buf.getvalue(), None
    except Exception as e:  # a failing variant is a bug in the system
        return [], buf.getvalue() + traceback.format_exc(), (
            cell, variant, repr(e))


def jobs_for(cells, variant: Optional[str] = None, quick: bool = False,
             depth: Optional[int] = None) -> list:
    """The job tuples of ``cells`` (names of :data:`CELLS` and
    ``detector_stitch``): each variant of a cell, or only ``variant``."""
    jobs = []
    for cell in cells:
        if cell == "detector_stitch":
            jobs.append((cell, None, quick, depth))
            continue
        for v in ([variant] if variant else list(CELLS[cell]["variants"])):
            jobs.append((cell, v, quick, depth))
    return jobs


def run_jobs(jobs, n_jobs: Optional[int] = None, echo: bool = True):
    """Run ``jobs`` (:func:`jobs_for`), ``n_jobs`` at once in spawned
    worker processes (default: one a CPU of this process's affinity; each
    starts its own fake process group); with ``echo`` each job's lines are
    printed in the jobs' order.  Returns (rows, failures)."""
    if n_jobs is None:
        n_jobs = len(os.sched_getaffinity(0))
    if n_jobs > 1 and len(jobs) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(
                max_workers=min(n_jobs, len(jobs)),
                mp_context=mp.get_context("spawn")) as ex:
            futures = [ex.submit(_job, *job) for job in jobs]
            done = [f.result() for f in futures]
    else:
        done = [_job(*job) for job in jobs]
    rows, failures = [], []
    for got, text, failure in done:
        if echo:
            print(text, end="", flush=True)
        rows.extend(got)
        if failure is not None:
            failures.append(failure)
    return rows, failures


def merge_rows(results: list, rows: list) -> list:
    """``results`` with each row of ``rows`` replacing the row of the same
    cell and variant (and geometry, for ``kernel_blocks``)."""
    def key(r):
        return (r["cell"], r["variant"], r.get("m"), r.get("n"),
                r.get("patch"), r.get("d_model"))
    new = {key(r) for r in rows}
    return [r for r in results if key(r) not in new] + list(rows)


def write_rows(rows: list, out: str = None) -> list:
    """Merge ``rows`` into the file :data:`OUT` (or ``out``); returns the
    file's rows."""
    out = out or OUT
    results = []
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results = merge_rows(results, rows)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cell", default="all",
                   choices=list(CELLS) + ["all", "detector_stitch",
                                          "kernel_blocks"])
    p.add_argument("--variant")
    p.add_argument("--quick", action="store_true",
                   help="the direct count only (no secant runs)")
    p.add_argument("--depth", type=int,
                   help="cut every model to this many layers")
    args = p.parse_args(argv)

    if args.cell == "kernel_blocks":
        rows = run_kernel_blocks()
        results = write_rows(rows)
        print(f"wrote {OUT} ({len(results)} rows)")
        return 0
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    jobs = jobs_for(cells, args.variant, args.quick, args.depth)
    rows, failures = run_jobs(jobs, None if args.cell == "all" else 1)
    results = write_rows(rows)
    print(f"wrote {OUT} ({len(results)} rows)")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
