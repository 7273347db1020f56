#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from the sources in the checkout
   (one ``nvcc`` per source, all started together);
3. hold K1 stitch and K2 unstitch bit-exact against their plain PyTorch
   versions on packer-built plans at canvas 1024 (f32, bf16, int8, uint8,
   placements flush with the canvas edges, an empty plan);
3b. hold K4 stitch->embed (f32 weights within 1e-4 with TF32 off in the
   plain matmul, bf16 within 2e-2) and K3 decode->gather (within 1e-5,
   equal hit masks but for centres within 1e-4 px of a placement edge)
   against their plain versions on the same plans and an all-invalid one,
   at patch 32 and d 768;
4. serve a synthetic trace through the full-width ``tangram`` detector
   (ViT-B/32 trunk, 1024^2 canvases, bf16) with the sync executor, once
   through the kernels and once through the plain versions, and require
   equal routed detections, bit-equal evidence pixels and head outputs,
   and 0 frames held;
5. serve the same trace through the async executor and require the same;
5b. serve it again on the fused path (K4 -> trunk from tokens -> K3):
   kernels sync, plain sync, kernels async; require K3/K4 launched and
   K1/K2 not (nothing in the plain run), 0 frames held, the unfused runs'
   invocation boundaries and bit-equal evidence, kernel and plain raw heads
   and routed detections within the stated bf16 tolerances, async equal to
   sync; print how far fused and unfused detections agree;
6. time each kernel at the main path's largest invocation against its
   plain version and its bound, time the unfused and the fused
   invocation's stages, and print one JSON line of kernels;
7. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
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
from repro_torch.kernels.stitch import fused_embed  # noqa: E402
from repro_torch.kernels.stitch import ops as stitch_ops  # noqa: E402
from repro_torch.kernels.stitch import stitch as stitch_kernels  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    fused_kwargs, profile, summary_line)
from repro_torch.models import detector as detector_lib  # noqa: E402
from repro_torch.models import vit  # noqa: E402
from repro_torch.sources import make_source  # noqa: E402

CANVAS = 1024
PATCH = 32
D_MODEL = 768
H100 = HardwareConfig()
F32_PEAK = 67e12    # float32 FLOP/s on the CUDA cores (H100 SXM data sheet)
LAUNCHES = stitch_kernels.LAUNCHES
UNFUSED = ("stitch", "unstitch")
FUSED = ("stitch_embed", "unstitch_decode")

# Fused kernel run vs fused plain run.  K4 sums in another order than the
# plain matmul, so a token may round one bf16 ulp apart, and the 12-layer
# bf16 trunk carries that to the head.  Measured on an H100 80GB HBM3 at
# 700 W over both traces (PERF.md): raw head 0.039, decoded score 0.0071,
# box 2.69 px at most; the limits are about three times those.  A box edge
# moves by up to 32 * (0.25 * d_centre + 0.5 * exp(r) * d_size) px for a
# raw change d, so its limit is in pixels, not a share of the raw one.
RAW_TOL = 0.125
SCORE_TOL = 0.025
BOX_TOL = 8.0


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
    """Build every kernel library at once, one nvcc per source."""
    t0 = time.perf_counter()
    modules = (stitch_kernels, fused_embed)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        for future in [pool.submit(mod.library) for mod in modules]:
            future.result()
    log(f"built {len(modules)} libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    for mod in modules:
        info = _build.BUILDS[mod.LIBRARY]
        log(f"  {mod.LIBRARY}: nvcc {info['seconds']:.2f}s -> "
            f"{info['path']}")
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


def plan_cases():
    """The plans both kernel checks run: random sizes, placements flush
    with the canvas edges, and an empty plan."""
    rng = np.random.default_rng(0)
    random_sizes = [(int(rng.integers(8, CANVAS // 2 + 1)),
                     int(rng.integers(8, CANVAS // 2 + 1)))
                    for _ in range(24)]
    # 4 x 512^2 tile a canvas exactly (placements flush with the right and
    # bottom edges), then a full canvas and a full-height strip
    flush_sizes = [(512, 512)] * 4 + [(1024, 1024), (320, 1024), (704, 16)]
    return [("random", random_sizes), ("edge-flush", flush_sizes),
            ("empty", [])]


def check_kernels(device) -> float:
    """K1/K2 vs their plain versions; returns the largest abs difference
    seen (required to be 0: the kernels are bit-exact copies)."""
    cases = plan_cases()
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


# --------------------------------------------------------------- phase 3b ----

def decoded_centres(raw: torch.Tensor, patch: int):
    """(cx, cy) of every cell, by the plain decode math."""
    side_m, side_n = raw.shape[1:3]
    gy, gx = torch.meshgrid(
        torch.arange(side_m, dtype=torch.float32, device=raw.device),
        torch.arange(side_n, dtype=torch.float32, device=raw.device),
        indexing="ij")
    r = raw.float()
    return ((gx + torch.sigmoid(r[..., 1])) * patch,
            (gy + torch.sigmoid(r[..., 2])) * patch)


def compare_k3(grids, plain, raw, records: np.ndarray, patch: int):
    """K3 vs its plain version: hit masks equal except at cells whose
    decoded centre lies within 1e-4 px of a placement edge (counted), and
    every other value within 1e-5 abs/rel.  Returns (max abs err, edge
    cells)."""
    differ = (grids[..., 0] > 0) != (plain[..., 0] > 0)
    edge = 0
    if differ.any():
        cx, cy = decoded_centres(raw, patch)
        where = {int(r[1]): (bi, *map(int, r[2:]))
                 for bi, per in enumerate(records) for r in per if r[0] > 0}
        for slot, gy, gx in differ.nonzero().tolist():
            bi, x, y, w, h = where[slot]
            cxv, cyv = float(cx[bi, gy, gx]), float(cy[bi, gy, gx])
            dist = min(abs(cxv - x), abs(cxv - x - w), abs(cyv - y),
                       abs(cyv - y - h))
            if dist > 1e-4:
                raise AssertionError(f"K3 hit masks differ at slot {slot} "
                                     f"cell ({gy}, {gx}), {dist} px from "
                                     f"the placement's edges")
            edge += 1
    keep = (~differ)[..., None]
    got, want = grids * keep, plain * keep
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"K3 differs from its plain version: max abs "
                             f"err {max_abs_err(got, want)}")
    return max_abs_err(got, want), edge


def check_fused_kernels(device) -> dict:
    """K4/K3 vs their plain versions on the K1/K2 plans and an all-invalid
    one; returns the largest abs errors seen per kernel and weight dtype."""
    rng = np.random.default_rng(3)
    k_dim = PATCH * PATCH * 3
    weights = rng.normal(size=(k_dim, D_MODEL)).astype(np.float32)
    weights /= np.sqrt(k_dim)
    bias = rng.normal(size=(D_MODEL,)).astype(np.float32)
    cases = plan_cases()
    cases.append(("all-invalid", cases[0][1]))
    worst = {"stitch_embed_float32": 0.0, "stitch_embed_bfloat16": 0.0,
             "unstitch_decode": 0.0}
    edge_cells = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, sizes in cases:
        plan, slots, records = packed_plan(sizes, 1, torch.float32, device)
        if name == "all-invalid":
            records = records.clone()
            records[..., 0] = 0
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            kernel = torch.from_numpy(weights).to(device, dtype)
            b = torch.from_numpy(bias).to(device, dtype)
            got = stitch_ops.stitch_embed(slots, records, kernel, b, CANVAS,
                                          CANVAS, PATCH, impl="cuda")
            want = stitch_ops.stitch_embed(slots, records, kernel, b,
                                           CANVAS, CANVAS, PATCH,
                                           impl="torch")
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            key = f"stitch_embed_{str(dtype).split('.')[-1]}"
            worst[key] = max(worst[key], err)
            ok = (got.shape == want.shape and got.dtype == dtype
                  and torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            if name == "all-invalid":
                ok = ok and torch.equal(got, b.expand_as(got))
            log(f"  K4 {str(dtype):15s} {name:11s} B={plan.num_canvases} "
                f"K={plan.slots_per_canvas}: max abs err {err:.3g} "
                f"(tol {tol:g}) {'ok' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"K4 differs from its plain version: "
                                     f"{dtype} {name}, max abs err {err}")
            side = CANVAS // PATCH
            raw = torch.from_numpy(rng.normal(
                size=(plan.num_canvases, side, side, 5)).astype(
                    np.float32)).to(device, dtype)
            grids = stitch_ops.unstitch_decode(raw, records, PATCH,
                                               plan.slot_capacity,
                                               impl="cuda")
            plain = stitch_ops.unstitch_decode(raw, records, PATCH,
                                               plan.slot_capacity,
                                               impl="torch")
            torch.cuda.synchronize()
            err, edge = compare_k3(grids, plain, raw, records.cpu().numpy(),
                                   PATCH)
            worst["unstitch_decode"] = max(worst["unstitch_decode"], err)
            edge_cells += edge
            log(f"  K3 raw {str(dtype):11s} {name:11s}: max abs err "
                f"{err:.3g}, {int((plain[..., 0] > 0).sum())} cells kept, "
                f"{edge} edge cells excused")
    log(f"  K3 hit masks: {edge_cells} cells excused as within 1e-4 px of "
        f"a placement edge")
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
        before = dict(LAUNCHES)
        plain_ms = time_ms(plain)
        ms = time_ms(kern)
        LAUNCHES.update(before)   # timing launches not counted
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


def serve_run(name: str, impl, build, table, arrivals, frames, device,
              fuse: bool = False):
    """One full serve of the trace; returns what the run routed and the
    detector head outputs of every invocation ((obj, boxes) unfused, the
    raw head fused)."""
    cfg, params, serve_fn = build
    config = ServeConfig(max_canvases=4, executor=name, fuse=fuse)
    heads = []

    def recording_serve_fn(p, canvases):
        obj, boxes = serve_fn(p, canvases)
        heads.append((obj, boxes))
        return obj, boxes

    fused = fused_kwargs(cfg, params) if fuse else {}
    if fuse:
        tokens_fn = fused["tokens_fn"]

        def recording_tokens_fn(p, tokens):
            raw = tokens_fn(p, tokens)
            heads.append((raw,))
            return raw

        fused["tokens_fn"] = recording_tokens_fn
    ex = make_executor(name, serve_fn=recording_serve_fn, params=params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       impl=impl, max_inflight=config.max_inflight, **fused)
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
    launches = dict(LAUNCHES)
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
    heads = [tuple(t.float().cpu().numpy() for t in h) for h in heads]
    obj = [1 / (1 + np.exp(-h[0][..., 0])) if fuse else h[0]
           for h in heads]
    hit = np.mean(np.concatenate([o.ravel() for o in obj]) >= 0.5)
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


def same_bounds_and_evidence(a: dict, b: dict, what: str) -> None:
    if a["bounds"] != b["bounds"]:
        raise AssertionError(f"{what}: invocation boundaries differ")
    if set(a["pixels"]) != set(b["pixels"]) or any(
            len(a["pixels"][f]) != len(b["pixels"][f])
            or not all(np.array_equal(x, y)
                       for x, y in zip(a["pixels"][f], b["pixels"][f]))
            for f in a["pixels"]):
        raise AssertionError(f"{what}: evidence pixels differ")


def same_result(a: dict, b: dict, what: str) -> None:
    same_bounds_and_evidence(a, b, what)
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
    # the same trunk on bit-equal inputs: the head outputs must be equal
    # to the bit, which also holds K1's zero fill at the main path's shapes
    if len(a["heads"]) != len(b["heads"]) or not all(
            all(np.array_equal(x, y) for x, y in zip(ha, hb))
            for ha, hb in zip(a["heads"], b["heads"])):
        raise AssertionError(f"{what}: head outputs differ")
    n = sum(len(v) for v in ra.values())
    log(f"  {what}: {len(a['bounds'])} invocations, {n} routed detections "
        f"equal, evidence pixels and head outputs bit-equal")


def match_detections(a: dict, b: dict, score_tol: float, box_tol: float):
    """Pair each detection of ``a`` with an unused one of ``b`` in the same
    frame, score within ``score_tol`` and box within ``box_tol`` px.
    Returns (matched, unmatched ones within score_tol of 0.5, the other
    unmatched ones)."""
    matched, excused, bad = 0, 0, []
    for fid, dets in a.items():
        free = list(b.get(fid, []))
        for score, box in dets:
            hit = next((i for i, (s, bx) in enumerate(free)
                        if abs(s - score) <= score_tol and max(
                            abs(x - y) for x, y in zip(box, bx)) <= box_tol),
                       None)
            if hit is not None:
                free.pop(hit)
                matched += 1
            elif abs(score - 0.5) <= score_tol:
                excused += 1
            else:
                bad.append((fid, score, box))
    return matched, excused, bad


def decoded_grid_diffs(a: dict, b: dict):
    """Both runs' raw heads decoded by the plain K3 per invocation: the
    largest score and box differences over cells both keep at 0.5."""
    d_score = d_box = 0.0
    for inv, (ra,), (rb,) in zip(a["invocations"], a["heads"], b["heads"]):
        rec = torch.from_numpy(inv.batch_plan().records)
        ga, gb = (stitch_ops.unstitch_decode_reference(
            torch.from_numpy(r), rec, PATCH, len(inv.patches))
            for r in (ra, rb))
        both = (ga[..., 0] >= 0.5) & (gb[..., 0] >= 0.5)
        if both.any():
            diff = (ga - gb).abs()[both]
            d_score = max(d_score, float(diff[:, 0].max()))
            d_box = max(d_box, float(diff[:, 1:].max()))
    return d_score, d_box


def compare_fused(kern: dict, plain: dict, what: str) -> None:
    """Fused kernel run vs fused plain run: raw heads within RAW_TOL, the
    decoded cells both keep within SCORE_TOL / BOX_TOL, and every routed
    detection paired within those, or within SCORE_TOL of 0.5."""
    raw_err = max(float(np.abs(ha[0] - hb[0]).max())
                  for ha, hb in zip(kern["heads"], plain["heads"]))
    d_score, d_box = decoded_grid_diffs(kern, plain)
    log(f"  {what}: raw head max abs diff {raw_err:.4g} (tol {RAW_TOL}), "
        f"decoded score {d_score:.4g} (tol {SCORE_TOL}), box {d_box:.4g} px "
        f"(tol {BOX_TOL})")
    if raw_err > RAW_TOL or d_score > SCORE_TOL or d_box > BOX_TOL:
        raise AssertionError(f"{what}: outside the stated tolerances")
    total, excused = 0, 0
    for x, y in ((kern, plain), (plain, kern)):
        matched, exc, bad = match_detections(x["routed"], y["routed"],
                                             SCORE_TOL, BOX_TOL)
        if bad:
            raise AssertionError(f"{what}: {len(bad)} detections without a "
                                 f"partner, e.g. {bad[:3]}")
        total += matched + exc
        excused += exc
    log(f"  {what}: {total // 2} routed detections paired both ways, "
        f"{excused} excused as within {SCORE_TOL} of 0.5")


def fused_agreement(fused: dict, unfused: dict) -> float:
    """Share of the fused run's detections with a partner in the unfused
    run under the fused rule (not gated: the two round bf16 at different
    places)."""
    matched, _, _ = match_detections(fused["routed"], unfused["routed"],
                                     SCORE_TOL, BOX_TOL)
    n = sum(len(v) for v in fused["routed"].values())
    return matched / n if n else 1.0


def check_launches(run: dict, kernels: tuple, what: str) -> None:
    """``kernels`` launched at least once in the run, every other kernel
    not at all."""
    ok = all((run["launches"][k] > 0) == (k in kernels)
             for k in run["launches"])
    if not ok:
        raise AssertionError(f"{what}: launches {run['launches']}, "
                             f"expected {kernels} only")


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
    """Device time of each stage of one unfused invocation (CUDA events)."""
    cfg, params, serve_fn = build
    canvases = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS)
    before = dict(LAUNCHES)
    det_ms = time_ms(lambda: serve_fn(params, canvases), iters=10)
    patch_out = stitch_ops.unstitch_patches(
        canvases, records, plan.slot_capacity, plan.hmax, plan.wmax)
    LAUNCHES.update(before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = patch_out.cpu().numpy()
    d2h = (time.perf_counter() - t0) * 1e3
    log(f"  unfused: detector ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.compute_dtype}) on {plan.num_canvases} canvases: "
        f"{det_ms:.3f} ms; evidence device->host {d2h:.2f} ms for "
        f"{host.nbytes / 1e6:.1f} MB")


def fused_rows(plan, slots, records, build, launches, worst) -> list:
    """Time K4/K3 on one plan with the model's own weights and head, and
    the fused invocation's device stages.  K4's bound: 2*B*seq*K*d
    operations at the bf16 peak, or the bytes it must move (records,
    placed f32 pixels, weights, bias, tokens written), whichever is
    larger; K3's: the bytes (records, raw head, grids written) or about
    30 float32 operations per cell at the CUDA cores' peak."""
    cfg, params, _ = build
    tokens_fn = detector_lib.tokens_fn(cfg)
    kernel, bias = detector_lib.embed_params(cfg, params)
    m = n = CANVAS
    b, cap = plan.num_canvases, plan.slot_capacity
    seq = (m // PATCH) * (n // PATCH)
    k_dim, d = kernel.shape
    before = dict(LAUNCHES)
    tokens = stitch_ops.stitch_embed(slots, records, kernel, bias, m, n,
                                     PATCH)
    raw = tokens_fn(params, tokens)
    # the library yardstick for K4: one cuBLAS GEMM plus bias on the canvas
    # batch already stitched and patchified in bf16 (the port never calls it)
    x = vit.patchify(stitch_ops.stitch_canvases(slots, records, m, n),
                     PATCH).to(kernel.dtype).contiguous()
    k4_plain = time_ms(lambda: stitch_ops.stitch_embed(
        slots, records, kernel, bias, m, n, PATCH, impl="torch"), iters=10)
    k4_ms = time_ms(lambda: stitch_ops.stitch_embed(
        slots, records, kernel, bias, m, n, PATCH, impl="cuda"))
    k4_lib = time_ms(lambda: torch.matmul(x, kernel) + bias)
    trunk_ms = time_ms(lambda: tokens_fn(params, tokens), iters=10)
    k3_plain = time_ms(lambda: stitch_ops.unstitch_decode(
        raw, records, PATCH, cap, impl="torch"), iters=10)
    k3_ms = time_ms(lambda: stitch_ops.unstitch_decode(
        raw, records, PATCH, cap, impl="cuda"))
    grids = stitch_ops.unstitch_decode(raw, records, PATCH, cap)
    LAUNCHES.update(before)      # timing launches not counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = grids.cpu().numpy()
    d2h = (time.perf_counter() - t0) * 1e3

    rec_bytes = records.numel() * 4
    k4_ops = 2 * b * seq * k_dim * d
    k4_bytes = (rec_bytes + placed_elements(plan) * 4
                + kernel.numel() * kernel.element_size()
                + bias.numel() * bias.element_size()
                + tokens.numel() * tokens.element_size())
    k4_times = (k4_ops / H100.peak_flops, k4_bytes / H100.hbm_bw)
    cells = raw.shape[1] * raw.shape[2]
    k3_ops = 30 * b * cells
    k3_bytes = (rec_bytes + raw.numel() * raw.element_size()
                + grids.numel() * 4)
    k3_times = (k3_ops / F32_PEAK, k3_bytes / H100.hbm_bw)
    source = "src/repro_torch/kernels/stitch/csrc/fused_embed.cu"
    rows = [
        {"name": "stitch_embed", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/stitch/fused_embed.py:114",
         "launches": launches["stitch_embed"],
         "max_abs_err": worst["stitch_embed_bfloat16"],
         "max_abs_err_f32_weights": worst["stitch_embed_float32"],
         "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": max(k4_times) * 1e3,
         "bound_by": "operations" if k4_times[0] >= k4_times[1]
         else "bytes",
         "library_ms": k4_lib,
         "library_call": "torch.matmul(x, kernel) + bias: the cuBLAS GEMM "
                         "alone, on the stitched, patchified bf16 canvas "
                         "batch"},
        {"name": "unstitch_decode", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/stitch/fused_embed.py:202",
         "launches": launches["unstitch_decode"],
         "max_abs_err": worst["unstitch_decode"],
         "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": max(k3_times) * 1e3,
         "bound_by": "operations" if k3_times[0] >= k3_times[1]
         else "bytes",
         "library_ms": None}]
    log(f"  stitch_embed: {k4_ms:.4f} ms (plain {k4_plain:.4f} ms, cuBLAS "
        f"GEMM + bias {k4_lib:.4f} ms, bound {rows[0]['bound_ms']:.4f} ms "
        f"for {k4_ops / 1e9:.2f} GFLOP / {k4_bytes / 1e6:.2f} MB)")
    log(f"  unstitch_decode: {k3_ms:.4f} ms (plain {k3_plain:.4f} ms, bound "
        f"{rows[1]['bound_ms']:.5f} ms for {k3_bytes / 1e6:.2f} MB)")
    log(f"  fused: K4 {k4_ms:.3f} ms; trunk from tokens ({cfg.n_layers} "
        f"layers) {trunk_ms:.3f} ms; K3 {k3_ms:.4f} ms; grids "
        f"device->host {d2h:.2f} ms for {host.nbytes / 1e6:.2f} MB")
    return rows


# ------------------------------------------------------------------ main ----

def serve_phases(build, table, arrivals, frames, device):
    """Phases 4 and 5 on one trace; returns the sync kernel, sync plain and
    async kernel runs."""
    kern = serve_run("device", None, build, table, arrivals, frames, device)
    check_launches(kern, UNFUSED, "unfused kernels")
    if not margin_filter(kern["routed"]):
        raise AssertionError("no detections routed: nothing to compare")
    plain = serve_run("device", "torch", build, table, arrivals, frames,
                      device)
    check_launches(plain, (), "unfused plain")
    same_result(kern, plain, "kernels vs plain")
    async_run = serve_run("async_device", None, build, table, arrivals,
                          frames, device)
    check_launches(async_run, UNFUSED, "unfused async")
    same_result(kern, async_run, "async vs sync")
    return kern, plain, async_run


def fused_phases(build, table, arrivals, frames, device, unfused: dict):
    """Phase 5b on one trace: the fused path, kernels sync, plain sync and
    kernels async, against each other and the unfused kernel run."""
    runs = {}
    for key, name, impl in (("sync", "device", None),
                            ("plain", "device", "torch"),
                            ("async", "async_device", None)):
        run = serve_run(name, impl, build, table, arrivals, frames, device,
                        fuse=True)
        check_launches(run, () if impl else FUSED, f"fused {key}")
        same_bounds_and_evidence(run, unfused, f"fused {key} vs unfused")
        runs[key] = run
    if not margin_filter(runs["sync"]["routed"]):
        raise AssertionError("fused: no detections routed")
    compare_fused(runs["sync"], runs["plain"], "fused kernels vs plain")
    same_result(runs["sync"], runs["async"], "fused async vs sync")
    log(f"  fused vs unfused (kernel runs, not gated): "
        f"{fused_agreement(runs['sync'], unfused):.4f} of fused detections "
        f"paired, {fused_agreement(unfused, runs['sync']):.4f} of unfused")
    return runs


def main() -> None:
    card = card_info()
    device = torch.device("cuda")
    log("phase 2: build")
    build_kernels()
    log("phase 3: K1/K2 vs plain versions (bit-exact)")
    worst = check_kernels(device)
    log("phase 3b: K4/K3 vs plain versions")
    worst_fused = check_fused_kernels(device)

    log("phase 4/5/5b: full-width tangram serve, unfused and fused, sync "
        "(kernels, plain) and async executors")
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
    runs, fused_runs, by_path = [], [], {}
    for slo in (5.0, 0.5):
        # the same trace under a tighter SLO fires more, smaller batches
        trace = [dataclasses.replace(a, patch=dataclasses.replace(
            a.patch, slo=slo)) for a in arrivals]
        log(f"  trace at SLO {slo}s:")
        for key, run in zip(("sync", "plain", "async"),
                            serve_phases(build, table, trace, frames,
                                         device)):
            by_path[f"unfused_{key}_slo{slo}"] = run["launches"]
            if key == "sync":
                runs.append(run)
        for key, run in fused_phases(build, table, trace, frames, device,
                                     runs[-1]).items():
            by_path[f"fused_{key}_slo{slo}"] = run["launches"]
            if key == "sync":
                fused_runs.append(run)
    # "launches": the main path (the sync kernel serves: unfused for K1/K2,
    # fused for K4/K3); each path's own count, read just after its run, in
    # "launches_by_path"
    launches = {k: sum(r["launches"][k]
                       for r in (runs if k in UNFUSED else fused_runs))
                for k in LAUNCHES}

    log("phase 6: kernel and stage times at the main path's largest "
        "invocation")
    plan, slots, records = main_path_plan(runs[0], frames, device)
    rows = kernel_rows(plan, slots, records, launches, worst)
    time_invocation(plan, slots, records, build)
    rows += fused_rows(plan, slots, records, build, launches, worst_fused)
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
