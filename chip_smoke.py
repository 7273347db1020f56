#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from the sources in the checkout;
3. hold K1 stitch and K2 unstitch bit-exact against their plain PyTorch
   versions on packer-built plans at canvas 1024 (f32, bf16, int8, uint8,
   placements flush with the canvas edges, an empty plan);
4. serve a synthetic trace through the full-width ``tangram`` detector
   (ViT-B/32 trunk, 1024^2 canvases, bf16) with the sync executor, once
   through the kernels and once through the plain versions, and require
   equal routed detections, bit-equal evidence pixels and head outputs,
   and 0 frames held;
5. serve the same trace through the async executor and require the same;
6. time each kernel at the main path's largest invocation against its
   plain version and its byte bound, and print one JSON line of kernels;
7. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.config import HardwareConfig  # noqa: E402
from repro_torch.core.config import ServeConfig  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    ServingEngine, make_executor, uniform_pool)
from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.core.partitioning import Patch  # noqa: E402
from repro_torch.core.stitching import build_batch_plan, stitch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stitch import ops as stitch_ops  # noqa: E402
from repro_torch.kernels.stitch import stitch as stitch_kernels  # noqa: E402
from repro_torch.launch.serve import profile, summary_line  # noqa: E402
from repro_torch.models import detector as detector_lib  # noqa: E402
from repro_torch.sources import make_source  # noqa: E402

CANVAS = 1024
H100 = HardwareConfig()


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1, 2 ----

def card_info() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def build_kernels() -> None:
    t0 = time.perf_counter()
    stitch_kernels.library()
    info = _build.BUILDS[stitch_kernels.LIBRARY]
    log(f"built {stitch_kernels.LIBRARY} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {info['seconds']:.2f}s) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3 ----

def packed_plan(sizes, seed: int, dtype: torch.dtype, device):
    """Packer-built plan + slots for patches of the given (w, h) sizes."""
    rng = np.random.default_rng(seed)
    patches = [Patch(0, 0, w, h, frame_id=i % 3)
               for i, (w, h) in enumerate(sizes)]
    canvases = stitch(patches, CANVAS, CANVAS)
    plan = build_batch_plan(patches, canvases, CANVAS, CANVAS)
    stitch_ops.check_records(plan)
    if dtype.is_floating_point:
        crops = [rng.normal(size=(p.h, p.w, 3)) for p in patches]
    else:
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        crops = [rng.integers(lo, hi, size=(p.h, p.w, 3)) for p in patches]
    slots = stitch_ops.pack_plan_host(
        [np.asarray(c, np.float32) for c in crops], plan)
    slots = torch.from_numpy(slots).to(device=device, dtype=dtype)
    records = torch.from_numpy(plan.records).to(device)
    return plan, slots, records


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


def check_kernels(device) -> float:
    """K1/K2 vs their plain versions; returns the largest abs difference
    seen (required to be 0: the kernels are bit-exact copies)."""
    rng = np.random.default_rng(0)
    random_sizes = [(int(rng.integers(8, CANVAS // 2 + 1)),
                     int(rng.integers(8, CANVAS // 2 + 1)))
                    for _ in range(24)]
    # 4 x 512^2 tile a canvas exactly (placements flush with the right and
    # bottom edges), then a full canvas and a full-height strip
    flush_sizes = [(512, 512)] * 4 + [(1024, 1024), (320, 1024), (704, 16)]
    cases = [("random", random_sizes), ("edge-flush", flush_sizes),
             ("empty", [])]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
        for name, sizes in cases:
            plan, slots, records = packed_plan(sizes, 1, dtype, device)
            got = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                             impl="cuda")
            want = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                              impl="torch")
            back = stitch_ops.unstitch_patches(
                got, records, plan.slot_capacity, plan.hmax, plan.wmax,
                impl="cuda")
            back_ref = stitch_ops.unstitch_patches(
                want, records, plan.slot_capacity, plan.hmax, plan.wmax,
                impl="torch")
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want), max_abs_err(back, back_ref))
            worst = max(worst, err)
            ok = (got.shape == want.shape and torch.equal(got, want)
                  and back.shape == back_ref.shape
                  and torch.equal(back, back_ref)
                  and torch.equal(back[:plan.num_patches],
                                  slots[:plan.num_patches]))
            log(f"  {str(dtype):15s} {name:10s} B={plan.num_canvases} "
                f"K={plan.slots_per_canvas} slots={plan.slot_capacity}x"
                f"{plan.hmax}x{plan.wmax}: {'bit-exact' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"kernel differs from plain version: "
                                     f"{dtype} {name}, max abs err {err}")
    return worst


# ---------------------------------------------------------------- timing ----

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def placed_elements(plan) -> int:
    r = plan.records[plan.records[..., 0] > 0]
    return int((r[:, 4] * r[:, 5]).sum()) * 3


def kernel_rows(plan, slots, records, launches, worst) -> list:
    """Time K1/K2 on one plan; bound = bytes moved / HBM rate."""
    e = slots.element_size()
    m = n = CANVAS
    rec_bytes = records.numel() * 4
    canvases = stitch_ops.stitch_canvases(slots, records, m, n)
    placed = placed_elements(plan) * e
    rows = []
    for name, replaces, kern, plain, out_bytes in (
            ("stitch", "src/repro/kernels/stitch/stitch.py:73",
             lambda: stitch_ops.stitch_canvases(slots, records, m, n,
                                                impl="cuda"),
             lambda: stitch_ops.stitch_canvases(slots, records, m, n,
                                                impl="torch"),
             canvases.numel() * e),
            ("unstitch", "src/repro/kernels/stitch/stitch.py:132",
             lambda: stitch_ops.unstitch_patches(
                 canvases, records, plan.slot_capacity, plan.hmax,
                 plan.wmax, impl="cuda"),
             lambda: stitch_ops.unstitch_patches(
                 canvases, records, plan.slot_capacity, plan.hmax,
                 plan.wmax, impl="torch"),
             plan.slot_capacity * plan.hmax * plan.wmax * 3 * e)):
        before = dict(stitch_kernels.LAUNCHES)
        plain_ms = time_ms(plain)
        ms = time_ms(kern)
        stitch_kernels.LAUNCHES.update(before)   # timing launches not counted
        moved = rec_bytes + placed + out_bytes
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/stitch/csrc/stitch.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / H100.hbm_bw * 1e3, "bound_by": "bytes",
            "library_ms": None})
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB) at "
            f"B={plan.num_canvases} K={plan.slots_per_canvas} "
            f"slots={plan.slot_capacity}x{plan.hmax}x{plan.wmax}")
    return rows


# ------------------------------------------------------------ phase 4, 5 ----

def make_trace(device, n_frames: int, slo: float):
    """Run the edge pipeline once on the card; keep its arrivals and the
    frames it shipped, so every serve run replays the same trace."""
    frames = {}

    def sink(frame_id, rgb, n_patches):
        frames[frame_id] = (rgb, n_patches)

    t0 = time.perf_counter()
    cam = make_source("synthetic", n_frames=n_frames, canvas=CANVAS,
                      slo=slo, frame_sink=sink, device=device)
    arrivals = list(cam.events(None))
    torch.cuda.synchronize()
    log(f"  edge pipeline: {n_frames} frames of {2 * CANVAS}x{CANVAS} -> "
        f"{len(arrivals)} patches in {time.perf_counter() - t0:.2f}s")
    return arrivals, frames


def calibrate_head(build, arrivals, frames, device) -> None:
    """Random weights leave the head's objectness logits in a narrow band
    below 0, and where the band lies moves with a canvas's content, so
    the full-width trunk routes nothing at threshold 0.5.  Pack the
    trace's own patches, all of them and each quarter of the trace, into
    probe canvases, and shift the objectness bias so that at least a
    quarter of the cells of every probe canvas clear the threshold: the
    serve runs then route detections to compare, in small invocations
    too."""
    cfg, params, _ = build
    patches = [a.patch for a in arrivals]
    q = -(-len(patches) // 4)
    groups = [patches] + [patches[i:i + q]
                          for i in range(0, len(patches), q)]
    logits = []
    with torch.inference_mode():
        for group in groups:
            plan = build_batch_plan(group, stitch(group, CANVAS, CANVAS),
                                    CANVAS, CANVAS)
            crops = [frames[p.frame_id][0][p.y0:p.y1, p.x0:p.x1]
                     for p in group]
            slots = torch.from_numpy(
                stitch_ops.pack_plan_host(crops, plan)).to(device)
            records = torch.from_numpy(plan.records).to(device)
            canvases = stitch_ops.stitch_canvases(slots, records, CANVAS,
                                                  CANVAS, impl="torch")
            out = detector_lib.forward(cfg, params, canvases)
            logits.append(out[..., 0].float().flatten(1))
    logits = torch.cat(logits)
    shift = float(logits.quantile(0.75, dim=1).min())
    params["det_head"]["bias"][0] -= shift
    log(f"  objectness bias shifted by {-shift:.4f} ({logits.shape[0]} "
        f"probe canvases, logits {float(logits.min()):.4f}.."
        f"{float(logits.max()):.4f})")


def serve_run(name: str, impl, build, table, arrivals, frames, device):
    """One full serve of the trace; returns what the run routed and the
    detector head outputs of every invocation."""
    cfg, params, serve_fn = build
    config = ServeConfig(max_canvases=4, executor=name)
    heads = []

    def recording_serve_fn(p, canvases):
        obj, boxes = serve_fn(p, canvases)
        heads.append((obj, boxes))
        return obj, boxes

    ex = make_executor(name, serve_fn=recording_serve_fn, params=params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       impl=impl, max_inflight=config.max_inflight)
    outputs = {}        # id(invocation) -> (per-frame dets, pixels)
    release = ex.on_complete

    def on_complete(comp):
        outputs[id(comp.invocation)] = comp.outputs
        release(comp)

    ex.on_complete = on_complete
    for frame_id, (rgb, n_patches) in frames.items():
        ex.add_frame(frame_id, rgb, n_patches)
    engine = ServingEngine(uniform_pool(CANVAS, CANVAS, table,
                                        max_canvases=config.max_canvases),
                           ex)
    source = make_source("trace", arrivals=arrivals)
    stitch_kernels.reset_launches()
    t0 = time.perf_counter()
    engine.serve(source)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(stitch_kernels.LAUNCHES)
    # merge in invocation order: measured wall times may deliver two
    # completions in either order
    routed, pixels = {}, {}
    for inv in engine.invocations:
        per_frame, per_frame_pixels = outputs[id(inv)]
        for fid, dets in per_frame.items():
            routed.setdefault(fid, []).extend(dets)
        for fid, px in per_frame_pixels.items():
            pixels.setdefault(fid, []).extend(px)
    log(f"  [{name}, {impl or 'kernels'}] "
        + summary_line(engine, ex, source.stats(), config, wall))
    heads = [(o.cpu().numpy(), b.cpu().numpy()) for o, b in heads]
    hit = np.mean(np.concatenate([o.ravel() for o, _ in heads]) >= 0.5)
    log(f"    launches {launches}, canvases per invocation "
        f"{[len(inv.canvases) for inv in engine.invocations]}, "
        f"{hit:.3f} of head cells at objectness >= 0.5")
    if len(ex.frames) != 0:
        raise AssertionError(f"{len(ex.frames)} frames still held")
    bounds = [[(p.frame_id, p.x0, p.y0) for p in inv.patches]
              for inv in engine.invocations]
    return {"routed": routed, "pixels": pixels, "launches": launches,
            "bounds": bounds, "invocations": engine.invocations,
            "heads": heads}


def margin_filter(per_frame, threshold=0.5, margin=1e-3):
    """Drop detections within ``margin`` of the threshold."""
    out = {}
    for fid, dets in per_frame.items():
        kept = [(s, b) for s, b in dets if abs(s - threshold) >= margin]
        if kept:
            out[fid] = kept
    return out


def same_result(a: dict, b: dict, what: str) -> None:
    if a["bounds"] != b["bounds"]:
        raise AssertionError(f"{what}: invocation boundaries differ")
    ra, rb = margin_filter(a["routed"]), margin_filter(b["routed"])
    if set(ra) != set(rb):
        raise AssertionError(f"{what}: routed frames differ")
    for fid in ra:
        if len(ra[fid]) != len(rb[fid]):
            raise AssertionError(f"{what}: frame {fid} detection counts "
                                 f"{len(ra[fid])} != {len(rb[fid])}")
        for (sa, ba), (sb, bb) in zip(ra[fid], rb[fid]):
            if abs(sa - sb) > 1e-4 or max(
                    abs(x - y) for x, y in zip(ba, bb)) > 1e-3:
                raise AssertionError(f"{what}: frame {fid} detections "
                                     f"differ: {(sa, ba)} vs {(sb, bb)}")
    if set(a["pixels"]) != set(b["pixels"]) or any(
            len(a["pixels"][f]) != len(b["pixels"][f])
            or not all(np.array_equal(x, y)
                       for x, y in zip(a["pixels"][f], b["pixels"][f]))
            for f in a["pixels"]):
        raise AssertionError(f"{what}: evidence pixels differ")
    # the same trunk on bit-equal canvases: the head outputs must be equal
    # to the bit, which also holds K1's zero fill at the main path's shapes
    if len(a["heads"]) != len(b["heads"]) or not all(
            np.array_equal(oa, ob) and np.array_equal(xa, xb)
            for (oa, xa), (ob, xb) in zip(a["heads"], b["heads"])):
        raise AssertionError(f"{what}: head outputs differ")
    n = sum(len(v) for v in ra.values())
    log(f"  {what}: {len(a['bounds'])} invocations, {n} routed detections "
        f"equal, evidence pixels and head outputs bit-equal")


# ---------------------------------------------------------------- phase 6 ----

def main_path_plan(run: dict, frames: dict, device):
    """The main path's largest invocation, re-packed from its frames."""
    inv = max(run["invocations"],
              key=lambda i: (len(i.canvases), len(i.patches)))
    plan = inv.batch_plan()
    crops = [frames[p.frame_id][0][p.y0:p.y1, p.x0:p.x1]
             for p in inv.patches]
    t0 = time.perf_counter()
    host = stitch_ops.pack_plan_host(crops, plan)
    t1 = time.perf_counter()
    slots = torch.from_numpy(host).to(device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  host staging at the largest invocation ({len(inv.patches)} "
        f"patches, {plan.num_canvases} canvases): pack "
        f"{(t1 - t0) * 1e3:.2f} ms, host->device {(t2 - t1) * 1e3:.2f} ms "
        f"for {host.nbytes / 1e6:.1f} MB")
    records = torch.from_numpy(plan.records).to(device)
    return plan, slots, records


def time_invocation(plan, slots, records, build) -> None:
    """Device time of each stage of one invocation (CUDA events)."""
    cfg, params, serve_fn = build
    canvases = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS)
    before = dict(stitch_kernels.LAUNCHES)
    det_ms = time_ms(lambda: serve_fn(params, canvases), iters=10)
    patch_out = stitch_ops.unstitch_patches(
        canvases, records, plan.slot_capacity, plan.hmax, plan.wmax)
    stitch_kernels.LAUNCHES.update(before)
    t0 = time.perf_counter()
    host = patch_out.cpu().numpy()
    d2h = (time.perf_counter() - t0) * 1e3
    log(f"  detector ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.compute_dtype}) on {plan.num_canvases} canvases: "
        f"{det_ms:.3f} ms; evidence device->host {d2h:.2f} ms for "
        f"{host.nbytes / 1e6:.1f} MB")


# ------------------------------------------------------------------ main ----

def serve_phases(build, table, arrivals, frames, device):
    """Phases 4 and 5 on one trace; returns the sync and async kernel
    runs."""
    kern = serve_run("device", None, build, table, arrivals, frames, device)
    if min(kern["launches"].values()) < 1:
        raise AssertionError(f"kernels not launched: {kern['launches']}")
    if not margin_filter(kern["routed"]):
        raise AssertionError("no detections routed: nothing to compare")
    plain = serve_run("device", "torch", build, table, arrivals, frames,
                      device)
    if max(plain["launches"].values()) > 0:
        raise AssertionError("plain run launched kernels")
    same_result(kern, plain, "kernels vs plain")
    async_run = serve_run("async_device", None, build, table, arrivals,
                          frames, device)
    if min(async_run["launches"].values()) < 1:
        raise AssertionError(f"kernels not launched: "
                             f"{async_run['launches']}")
    same_result(kern, async_run, "async vs sync")
    return kern, async_run


def main() -> None:
    card = card_info()
    device = torch.device("cuda")
    log("phase 2: build")
    build_kernels()
    log("phase 3: kernels vs plain versions (bit-exact)")
    worst = check_kernels(device)

    log("phase 4/5: full-width tangram serve, sync (kernels, plain) and "
        "async executors")
    t0 = time.perf_counter()
    build = make_model("tangram").build(reduced=False, device=device)
    cfg = build[0]
    log(f"  built {cfg.name}: canvas {cfg.canvas}, patch {cfg.patch}, "
        f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, {cfg.param_dtype} ({cfg.n_params / 1e6:.1f}M "
        f"params) in {time.perf_counter() - t0:.1f}s")
    arrivals, frames = make_trace(device, n_frames=24, slo=5.0)
    calibrate_head(build, arrivals, frames, device)
    table = profile(build[2], build[1], CANVAS, CANVAS, device)
    log("  latency table: " + str({k: (round(v[0], 5), round(v[1], 5))
                                  for k, v in table.table.items()}))
    runs, by_path = [], {}
    for slo in (5.0, 0.5):
        # the same trace under a tighter SLO fires more, smaller batches
        trace = [dataclasses.replace(a, patch=dataclasses.replace(
            a.patch, slo=slo)) for a in arrivals]
        log(f"  trace at SLO {slo}s:")
        sync_run, async_run = serve_phases(build, table, trace, frames,
                                           device)
        runs.append(sync_run)
        by_path[f"sync_slo{slo}"] = sync_run["launches"]
        by_path[f"async_slo{slo}"] = async_run["launches"]
    # "launches": the main path (the sync kernel serves); each path's own
    # count, read just after its run, in "launches_by_path"
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in stitch_kernels.LAUNCHES}

    log("phase 6: kernel times at the main path's largest invocation")
    plan, slots, records = main_path_plan(runs[0], frames, device)
    rows = kernel_rows(plan, slots, records, launches, worst)
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
    time_invocation(plan, slots, records, build)
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
