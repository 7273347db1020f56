"""One run of a benchmark cell: the port serves camera patches for
``--seconds`` through its normal fused path, then the outputs are held
against the plain reference.

The cell, its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``) and its metrics (``metrics/<name>.py``, one
reader each) are found by name from ``BENCHMARK.json``.

What the window drives, built as ``repro_torch.launch.serve`` builds a
single-model fused server: the registry model's trunk with the
benchmark's weights, the fused fields of ``fused_kwargs`` (K4
stitch->embed, the trunk from tokens, K3 decode->gather, ``route_fused``)
on an ``AsyncDeviceExecutor``, a one-worker ``WorkerPoolExecutor`` feeding
an ``OnlineLatencyTable`` seeded by ``profile``, the SLO-aware invoker
pool (``uniform_pool``) and ``ServingEngine.serve`` on a ``WallClock``.
The benchmark records spans only from its own code: around the worker's
``submit`` (staging), ``resolve`` (outputs routed) and ``tokens_fn`` (K4's
tokens and the trunk's head, kept for the sampled invocations).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tangram_bench import families, reference
from tangram_bench.traffic import generator
from tangram_bench.weights import make_weights, set_objectness

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: how many of the machine's cores a run keeps to (:func:`steady_process`)
CORES = 4
#: the output check's numbers that must read 0
EXACT_CHECKS = ("plan_mismatch", "route_mismatch", "route_outside",
                "lost_patches")
#: the statistic of :func:`gaps` each tensor comparison is held to: the
#: ones whose program and control readings lie furthest apart (PERF.md).
#: ``_rel``: over the same statistic of the reference in bf16 (the
#: yardstick), which takes out how far a seed's random trunk amplifies
#: rounding
COMPARED = {"k4_token_err": "maxmax", "head_err": "rmsrms_rel"}
#: the statistics read over the yardstick's
RELATIVE = ("chanstd", "rmsrms")


# -------------------------------------------------------------- the cell ----

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: pathlib.Path = ROOT / "BENCHMARK.json"
              ) -> tuple:
    """(cell, config, traffic, bench) of workload ``name``."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT / config["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic, bench


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    every entry whose ``workloads`` names the cell or that has none."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tangram_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def steady_process() -> None:
    """Keep the run on a fixed :data:`CORES` of the machine's cores, the
    last ones, with as many intra-op threads: the engine's thread and the
    driver's copies then stay on the same cores from run to run."""
    cores = sorted(os.sched_getaffinity(0))[-CORES:]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# ------------------------------------------------------------ recording ----

@dataclasses.dataclass
class InvRec:
    """One invocation as the benchmark saw it, in engine seconds."""
    t_submit0: float
    t_submit1: float
    n_patches: int
    n_canvases: int
    used_area: List[int]
    records: np.ndarray
    t_routed: Optional[float] = None
    detections: Optional[dict] = None
    patches: list = dataclasses.field(default_factory=list)  # program's


@dataclasses.dataclass
class Sample:
    """A sampled invocation's program outputs, kept for the check."""
    inv: object
    rec: InvRec
    tokens: torch.Tensor
    raw: torch.Tensor
    fused: torch.Tensor


class Recorder:
    """Spans and outputs of one window, from wrappers around the worker
    executor's ``submit`` / ``resolve`` and the runtime's ``tokens_fn``.
    Of the invocations whose submit starts in the window, ``n_samples``
    drawn with ``rng`` (reservoir sampling) and the one with the most
    patches keep their outputs for the check."""

    def __init__(self, seconds: float, n_samples: int, rng):
        self.seconds = seconds
        self.n_samples = n_samples
        self.rng = rng
        self.epoch = 0.0
        self.invs: Dict[int, InvRec] = {}
        self.order: List[InvRec] = []
        self.spans: List[tuple] = []
        self.samples: List[Sample] = []
        self.longest: Optional[Sample] = None
        self.n_window = 0
        self.capture: Optional[dict] = None
        self.recording = False

    def now(self) -> float:
        return time.perf_counter() - self.epoch

    def wrap(self, executor) -> None:
        submit, resolve = executor.submit, executor.resolve

        def timed_submit(inv):
            if not self.recording:
                return submit(inv)
            t0 = self.now()
            self.capture = {}
            handle = submit(inv)
            t1 = self.now()
            self.spans.append(("submit", t0, t1))
            self._submitted(inv, handle, t0, t1)
            self.capture = None
            return handle

        def timed_resolve(handle):
            if not self.recording:
                return resolve(handle)
            t0 = self.now()
            comp = resolve(handle)
            t1 = self.now()
            self.spans.append(("resolve", t0, t1))
            rec = self.invs.get(id(handle.invocation))
            if rec is not None:
                rec.t_routed = t1
                rec.detections = comp.outputs[0]
            return comp

        executor.submit, executor.resolve = timed_submit, timed_resolve

    def wrap_tokens_fn(self, fn):
        def tokens_fn(params, tokens):
            raw = fn(params, tokens)
            if self.capture is not None:
                self.capture["tokens"], self.capture["raw"] = tokens, raw
            return raw
        return tokens_fn

    def _submitted(self, inv, handle, t0, t1) -> None:
        plan = inv.plan
        used = [sum(p.w * p.h for p in c.placements) for c in inv.canvases]
        rec = InvRec(t0, t1, len(inv.patches), len(inv.canvases), used,
                     plan.records.copy(), patches=list(inv.patches))
        self.invs[id(inv)] = rec
        self.order.append(rec)
        if t0 >= self.seconds or "raw" not in self.capture:
            return
        sample = Sample(inv, rec, self.capture["tokens"], self.capture["raw"],
                        handle.payload["fused"])
        if self.longest is None or rec.n_patches > self.longest.rec.n_patches:
            self.longest = sample
        k = self.n_window
        self.n_window += 1
        if k < self.n_samples:
            self.samples.append(sample)
        else:
            j = int(self.rng.integers(0, k + 1))
            if j < self.n_samples:
                self.samples[j] = sample

    def checked_samples(self) -> List[Sample]:
        out = list(self.samples)
        if self.longest is not None and all(s is not self.longest
                                            for s in out):
            out.append(self.longest)
        return out


class DrainClock:
    """The port's ``WallClock`` during the window; once ``release`` is
    called (a replay's window has closed) it stops sleeping, so the
    backlog's far deadlines do not hold the drain."""

    def __init__(self, wall):
        self.wall = wall
        self.virtual = False
        self.released = False
        self.floor = 0.0

    def now(self) -> float:
        return max(self.wall.now(), self.floor)

    def advance_to(self, t: float) -> None:
        if not self.released:
            self.wall.advance_to(t)
        self.floor = max(self.floor, t)

    def release(self) -> None:
        self.released = True


# -------------------------------------------------------------- program ----

def detector_config(cfg: dict):
    """The registry model's ``DetectorConfig``, checked against the
    configuration file's values of its family's ``KEYS`` (a file without
    ``model`` builds its own, for the tests)."""
    from repro_torch.config import DetectorConfig
    from repro_torch.core.models import make_model
    keys = families.load(cfg).KEYS
    if "model" in cfg:
        arch = make_model(cfg["model"]).arch
        differ = [k for k in keys if getattr(arch, k) != cfg[k]]
        if differ:
            raise ValueError(f"registry model {cfg['model']!r} differs from "
                             f"{cfg['name']}.json in {differ}")
        return arch
    return DetectorConfig(name=cfg["name"], **{k: cfg[k] for k in keys})


@dataclasses.dataclass
class Program:
    arch: object
    params: dict
    worker: object        # the AsyncDeviceExecutor
    executor: object      # what the engine drives
    table: object


def build_program(cfg: dict, weights: dict, device: torch.device,
                  recorder: Recorder) -> Program:
    """The port's fused server over ``weights``, as ``launch/serve.py``
    builds one."""
    from repro_torch.core.engine import make_executor
    from repro_torch.core.latency import OnlineLatencyTable
    from repro_torch.core.workers import WorkerPoolExecutor
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.serve import fused_kwargs, profile
    from repro_torch.models import detector as detector_lib

    arch = detector_config(cfg)
    params = weights
    m = n = arch.canvas
    serve_fn = detector_lib.serve_fn(arch)
    mesh = make_serve_mesh(devices=[device])
    table = profile(serve_fn, params, m, n, device, mesh=mesh)
    if cfg["online_latency"]:
        table = OnlineLatencyTable(table)
    if not cfg["fuse"]:
        raise ValueError(f"{cfg['name']}: the benchmark drives the fused "
                         f"path (fuse: true)")
    fused = fused_kwargs(arch, params)
    fused["tokens_fn"] = recorder.wrap_tokens_fn(fused["tokens_fn"])
    worker = make_executor(
        "async_device", serve_fn=serve_fn, params=params, canvas_m=m,
        canvas_n=n, device=device, max_inflight=cfg["max_inflight"],
        mesh=mesh, **fused)
    recorder.wrap(worker)
    executor = worker
    if cfg["online_latency"]:
        executor = WorkerPoolExecutor([worker], estimator=table)
    return Program(arch, params, worker, executor, table)


def _to_patch(p: generator.PatchRec, slo: float):
    from repro_torch.core.partitioning import Patch
    return Patch(p.x0, p.y0, p.x1, p.y1, frame_id=p.frame_id,
                 camera_id=p.camera_id, t_gen=p.t_gen, slo=slo)


def warm_up(program: Program, clips, cfg: dict, traffic: dict) -> None:
    """Every canvas count the window can fire, 1 to ``max_canvases``, run
    twice on real patches through the executor the engine drives (both
    fused kernels and the trunk at each batch), so that the online
    latency table has seen each batch before the window, as a server that
    has been running has."""
    from repro_torch.core.invoker import Invocation
    from repro_torch.core.stitching import stitch
    m = n = program.arch.canvas
    worker = program.executor
    stream = [(c, i, r) for i in range(traffic["clip_frames"])
              for c in clips for r in c.rects[i]]
    fid = -1
    pos = 0
    for b in range(1, cfg["max_canvases"] + 1):
        for _ in range(2):
            patches = []
            while True:
                clip, idx, rect = stream[pos % len(stream)]
                p = generator.PatchRec(*rect, fid, clip.camera, 0.0)
                if len(stitch([*patches, p], m, n)) > b:
                    break
                patches.append(p)
                worker.add_frame(fid, clip.pixels[idx], 1)
                fid -= 1
                pos += 1
            patches = [_to_patch(p, 1.0) for p in patches]
            inv = Invocation(0.0, stitch(patches, m, n), patches, 0.0,
                             "warmup")
            handle = worker.submit(inv)
            comp = worker.resolve(handle)
            worker.on_complete(comp)


# --------------------------------------------------------------- sources ----

class ReplaySource:
    """The recorded backlog, all due at t = 0, handed to the engine frame
    by frame until the window closes."""

    def __init__(self, traffic, clips, book, seed, seconds, executor,
                 clock):
        self.frames = generator.replay_frames(traffic, clips, book, seed)
        self.seconds, self.executor, self.clock = seconds, executor, clock
        self.slo = float(traffic["slo_s"])
        self.offered = []
        self.ran_dry = False

    def events(self, engine):
        from repro_torch.data.video import Arrival
        for ev in self.frames:
            if self.clock.now() >= self.seconds:
                self.clock.release()
                return
            self.executor.add_frame(ev.frame_id, ev.pixels, len(ev.patches))
            for p in ev.patches:
                patch = _to_patch(p, self.slo)
                self.offered.append(patch)
                yield Arrival(0.0, patch, generator.patch_bytes(p))
        self.ran_dry = True
        self.clock.release()


class LiveSource:
    """Every camera's frames on its frame clock, each patch due at its
    uplink arrival; records how late the engine took each arrival."""

    def __init__(self, traffic, clips, book, seed, seconds, executor,
                 clock):
        events = generator.live_frames(traffic, clips, book, seed, seconds)
        self.arrivals = generator.live_arrivals(events)
        self.executor, self.clock = executor, clock
        self.slo = float(traffic["slo_s"])
        self.offered = []
        self.lateness = []
        self.ran_dry = False

    def events(self, engine):
        from repro_torch.data.video import Arrival
        registered = set()
        for t, _, p, ev in self.arrivals:
            self.lateness.append(max(0.0, self.clock.now() - t))
            if ev.frame_id not in registered:
                registered.add(ev.frame_id)
                self.executor.add_frame(ev.frame_id, ev.pixels,
                                        len(ev.patches))
            patch = _to_patch(p, self.slo)
            self.offered.append(patch)
            yield Arrival(t, patch, generator.patch_bytes(p))


SOURCES = {"replay": ReplaySource, "live": LiveSource}


# ---------------------------------------------------------------- a run ----

@dataclasses.dataclass
class RunData:
    """What a metric reader reads: the window's invocations and patches,
    the spans, and the device trace (``--trace 1``)."""
    seconds: float
    slo: float
    mode: str
    cfg: dict
    traffic: dict
    invs: List[InvRec]
    patches: List[tuple]          # (t_gen, t_routed or None), offered
    spans: List[tuple]
    trace: object = None
    lateness: List[float] = dataclasses.field(default_factory=list)
    readings: dict = dataclasses.field(default_factory=dict)
    control_readings: dict = dataclasses.field(default_factory=dict)
    check_s: float = 0.0


def serve_window(program: Program, clips, cfg, traffic, seed: int,
                 seconds: float, recorder: Recorder, tracer=None):
    """Serve the cell's traffic for ``seconds``, then drain; returns the
    source (offered patches) and the host time the window opened."""
    from repro_torch.core.clock import WallClock
    from repro_torch.core.engine import ServingEngine, uniform_pool
    m = n = program.arch.canvas
    pool = uniform_pool(m, n, program.table,
                        max_canvases=cfg["max_canvases"])
    book = generator.FrameBook(clips)
    if tracer is not None:
        tracer.start()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = WallClock(time_fn=time.perf_counter)
    recorder.epoch = time.perf_counter() - wall.now()
    if tracer is not None:
        tracer.mark(recorder)
    clock = DrainClock(wall)
    source = SOURCES[traffic["mode"]](traffic, clips, book, seed, seconds,
                                      program.executor, clock)
    engine = ServingEngine(pool, program.executor, clock=clock)
    # set-up's objects out of the window's collections; back after it, so
    # that the program's state can be collected before the check
    gc.collect()
    gc.freeze()
    recorder.recording = True
    with torch.no_grad():
        engine.serve(source)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    recorder.recording = False
    gc.unfreeze()
    if tracer is not None:
        tracer.stop()
    return source, engine, book


def patch_outcomes(recorder: Recorder, source) -> List[tuple]:
    """(t_gen, t_routed) of every offered patch, None when never routed."""
    routed = {id(p): rec.t_routed for rec in recorder.order
              for p in rec.patches}
    return [(p.t_gen, routed.get(id(p))) for p in source.offered]


# ----------------------------------------------------------------- check ----

def gaps(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """The widest gap over the largest magnitude (``maxmax``); the widest
    gap of each channel (the last axis) over that channel's spread about
    its mean, the worst channel (``chanstd``); the RMS gap over the RMS
    (``rmsrms``).  :data:`COMPARED` names the one each check holds."""
    diff = (got.float() - want).reshape(-1, want.shape[-1])
    ref = want.reshape(-1, want.shape[-1]).double()
    top = float(want.abs().max())
    rms = float(ref.pow(2).mean().sqrt())
    widest = float(diff.abs().max())
    spread = ref.std(dim=0).clamp_min(1e-30)
    return {"maxmax": widest / max(top, 1e-30),
            "chanstd": float((diff.abs().amax(dim=0).double()
                              / spread).max()),
            "rmsrms": float(diff.double().pow(2).mean().sqrt())
            / max(rms, 1e-30)}


def _multiset_gap(a: dict, b: dict) -> int:
    gap = 0
    for fid in set(a) | set(b):
        ca = collections.Counter(a.get(fid, []))
        cb = collections.Counter(b.get(fid, []))
        gap += sum((ca - cb).values()) + sum((cb - ca).values())
    return gap


def outside(rec: InvRec) -> int:
    """Routed detections of one invocation that name a frame it did not
    carry, or whose box leaves every patch it carried of that frame."""
    rects = collections.defaultdict(list)
    for p in rec.patches:
        rects[p.frame_id].append((p.x0, p.y0, p.x1, p.y1))
    bad = 0
    for fid, dets in (rec.detections or {}).items():
        for _, (bx0, by0, bx1, by1) in dets:
            if not any(x0 <= bx0 <= bx1 <= x1 and y0 <= by0 <= by1 <= y1
                       for x0, y0, x1, y1 in rects.get(fid, ())):
                bad += 1
    return bad


def control_outputs(canvases, records, weights, cfg, n_slots, origins):
    """The control in the program's place: the reference with every
    product's operands rounded to fp8 (``reference.mm_fp8``), the precision
    below the configuration's bf16.  Returns (tokens, raw, grids,
    routed)."""
    side = cfg["canvas"] // cfg["patch"]
    tokens = reference.embed(canvases, weights, cfg["patch"],
                             reference.mm_fp8)
    raw = families.load(cfg).detector_raw(tokens, weights, side,
                                          cfg["norm_eps"], reference.mm_fp8)
    grids = reference.decode_gather(raw, records, cfg["patch"], n_slots)
    routed = reference.route(records, origins, grids.cpu().numpy())
    return tokens, raw, grids, routed


def check(recorder: Recorder, source, book, cfg: dict, weights: dict,
          device: torch.device, control: bool = False,
          readings: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of one run (see ``limits`` in the
    configuration file): the program's outputs of each sampled invocation
    against the reference, or with ``control`` the control's.
    ``readings`` collects every statistic of :func:`gaps`, worst over the
    samples."""
    readings = {} if readings is None else readings
    m = n = cfg["canvas"]
    patch = cfg["patch"]
    side = m // patch
    detector_raw = families.load(cfg).detector_raw
    out = {"plan_mismatch": 0, "k4_token_err": 0.0, "head_err": 0.0,
           "k3_grid_err": 0.0, "route_mismatch": 0}
    samples = recorder.checked_samples()
    if not samples:
        # nothing of the window was captured: nothing could be compared
        out["k4_token_err"] = out["head_err"] = math.inf
    with reference.full_float32():
        for s in samples:
            patches = s.inv.patches
            ref_plan = reference.plan([(p.w, p.h) for p in patches], m, n)
            prog = s.inv.plan
            same = (np.array_equal(ref_plan["records"], prog.records)
                    and (ref_plan["hmax"], ref_plan["wmax"],
                         ref_plan["slot_capacity"])
                    == (prog.hmax, prog.wmax, prog.slot_capacity))
            out["plan_mismatch"] += int(not same)
            records = ref_plan["records"]
            n_slots = ref_plan["slot_capacity"]
            origins = [(p.frame_id, p.x0, p.y0) for p in patches]
            crops = [book.pixels(p.frame_id)[p.y0:p.y1, p.x0:p.x1]
                     for p in patches]
            canvases = reference.stitch(crops, records, m, n, device)
            if control:
                got = control_outputs(canvases, records, weights, cfg,
                                      n_slots, origins)
            else:
                got = (s.tokens, s.raw, s.fused, s.rec.detections or {})
            tokens = reference.embed(canvases, weights, patch)
            raw = detector_raw(tokens, weights, side, cfg["norm_eps"])
            yard = gaps(detector_raw(
                reference.embed(canvases, weights, patch, reference.mm_bf16),
                weights, side, cfg["norm_eps"], reference.mm_bf16), raw)
            del canvases
            g_tokens, g_raw, g_fused, g_routed = got
            if g_tokens.shape == tokens.shape:
                for name, a, b in (("k4_token_err", g_tokens, tokens),
                                   ("head_err", g_raw, raw)):
                    got_gaps = gaps(a, b)
                    if name == "head_err":
                        got_gaps.update({
                            f"{stat}_rel": got_gaps[stat]
                            / max(yard[stat], 1e-30) for stat in RELATIVE})
                    for stat, v in got_gaps.items():
                        key = f"{name}.{stat}"
                        readings[key] = max(readings.get(key, 0.0), v)
                        readings.setdefault(f"{key}.each", []).append(v)
                    out[name] = max(out[name],
                                    readings[f"{name}.{COMPARED[name]}"])
            else:
                out["k4_token_err"] = out["head_err"] = math.inf
            # K3 and the routing are judged on the head they were given:
            # the reference decodes and routes the program's own head, which
            # head_err holds to the reference's own (a layout that head and
            # K3 share moves the head, and head_err reads it)
            grids = reference.decode_gather(g_raw.float(), records, patch,
                                            n_slots)
            if grids.shape == g_fused.shape:
                out["k3_grid_err"] = max(
                    out["k3_grid_err"],
                    float((g_fused.float() - grids).abs().max()))
            else:
                out["k3_grid_err"] = math.inf
            routed = reference.route(records, origins,
                                     g_fused.float().cpu().numpy())
            out["route_mismatch"] += _multiset_gap(routed, g_routed)
    window = [r for r in recorder.order if r.t_submit0 < recorder.seconds]
    out["route_outside"] = sum(outside(r) for r in window)
    out["lost_patches"] = sum(1 for _, tr in patch_outcomes(recorder, source)
                              if tr is None)
    return out


def limits_of(cfg: dict) -> Dict[str, float]:
    lim = {name: 0 for name in EXACT_CHECKS}
    lim.update(cfg["limits"])
    return lim


# ------------------------------------------------------------------ main ----

def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def routable(records: np.ndarray, side: int, patch: int) -> torch.Tensor:
    """(B, side, side) mask of the cells whose centre lies inside a
    placement: the cells that can route a detection."""
    mask = torch.zeros((records.shape[0], side, side), dtype=torch.bool)
    centre = (torch.arange(side) + 0.5) * patch
    for bi, _, x, y, w, h in reference.placements(records):
        rows = (centre >= y) & (centre < y + h)
        cols = (centre >= x) & (centre < x + w)
        mask[bi] |= rows[:, None] & cols[None, :]
    return mask


def calibrate_objectness(weights: dict, clips, cfg: dict,
                         device: torch.device) -> float:
    """Set the head's objectness so that ``obj_share`` of the routable
    cells of each camera's first frame, packed alone, route a detection,
    from the float32 reference (``weights.set_objectness``)."""
    m, patch = cfg["canvas"], cfg["patch"]
    side = m // patch
    detector_raw = families.load(cfg).detector_raw
    cells = []
    with reference.full_float32():
        for clip in clips:
            rects = clip.rects[0]
            if not rects:
                continue
            sizes = [(x1 - x0, y1 - y0) for x0, y0, x1, y1 in rects]
            records = reference.plan(sizes, m, m)["records"]
            crops = [clip.pixels[0][y0:y1, x0:x1]
                     for x0, y0, x1, y1 in rects]
            canvas = reference.stitch(crops, records, m, m, device)
            tokens = reference.embed(canvas, weights, patch)
            raw = detector_raw(tokens, weights, side, cfg["norm_eps"])
            cells.append(raw[routable(records, side, patch).to(device)])
    return set_objectness(weights, torch.cat(cells), cfg["obj_share"])


def prepare(cfg: dict, traffic: dict, seed: int, device: torch.device,
            seconds: float, n_samples: int):
    """Weights, clips and the warmed program of one seed."""
    recorder = Recorder(seconds, n_samples, generator.seed_rng(seed + 1))
    weights = make_weights(cfg, seed, device)
    clips = generator.make_clips(traffic, seed, cfg["canvas"], device)
    calibrate_objectness(weights, clips, cfg, device)
    program = build_program(cfg, weights, device, recorder)
    warm_up(program, clips, cfg, traffic)
    return recorder, weights, clips, program


def run_checked(cfg, traffic, seed, device, seconds, tracer=None,
                control=False):
    """Prepare, serve one window and check it; returns (checks, run data,
    memory peak, window-open host time), and with ``control`` the
    control's numbers on the same samples after the program's."""
    recorder, weights, clips, program = prepare(
        cfg, traffic, seed, device, seconds, traffic["check_invocations"])
    t_open = time.perf_counter()
    source, engine, book = serve_window(program, clips, cfg, traffic, seed,
                                        seconds, recorder, tracer)
    if source.ran_dry:
        raise RuntimeError("the replay backlog ran dry before the window "
                           "closed: raise backlog_frames_per_camera")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    data = RunData(seconds, float(traffic["slo_s"]), traffic["mode"], cfg,
                   traffic, list(recorder.order),
                   patch_outcomes(recorder, source), list(recorder.spans),
                   tracer.data if tracer is not None else None,
                   getattr(source, "lateness", []))
    # the program's state goes before the reference runs
    del engine, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = {}
    t_check = time.perf_counter()
    checks = check(recorder, source, book, cfg, weights, device,
                   readings=readings)
    data.readings = readings
    data.check_s = time.perf_counter() - t_check
    if control:
        data.control_readings = {}
        checks = (checks, check(recorder, source, book, cfg, weights, device,
                                control=True,
                                readings=data.control_readings))
    return checks, data, peak, t_open


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, cfg, traffic, bench = load_cell(args.workload)
    readers = [(m, load_reader(m["name"]))
               for m in cell_metrics(bench, cell["name"], bool(args.trace))
               if m["name"] != "setup_s"]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    steady_process()
    set_cache_dirs()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tracer = None
    if args.trace:
        from tangram_bench.trace import DeviceTrace
        tracer = DeviceTrace()
    checks, data, peak, t_open = run_checked(
        cfg, traffic, args.seed, device, args.seconds, tracer=tracer)
    setup_s = t_open - t0
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    metrics = {}
    for m, read in readers:
        value = read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not args.trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    lim = limits_of(cfg)
    correct = all(checks[k] <= lim[k] for k in lim)
    n_attempted = len(data.patches)
    n_failed = sum(1 for _, tr in data.patches if tr is None)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_attempted,
              "failed": n_failed, "metrics": metrics, "device": device_info}
    if tracer is not None and tracer.data is not None:
        device_info["busy_s"] = tracer.data.busy_s
        device_info["window_s"] = tracer.data.window_s
        result["breakdown"] = tracer.data.breakdown(data)
    result["checks"] = {k: {"value": checks[k], "limit": lim[k]}
                        for k in lim}
    if data.lateness:
        late = sorted(data.lateness)
        print(f"arrivals taken late: p95 "
              f"{late[max(0, math.ceil(0.95 * len(late)) - 1)] * 1e3:.3f} "
              f"ms, max {late[-1] * 1e3:.3f} ms over {len(late)}",
              file=sys.stderr)
    n_det = sum(len(v) for r in data.invs for v in (r.detections or {})
                .values())
    print(f"setup_s {setup_s:.3f}; invocations {len(data.invs)}; patches "
          f"{n_attempted}; detections routed {n_det}; output check "
          f"{data.check_s:.3f} s", file=sys.stderr)
    for k in lim:
        print(f"check {k} {checks[k]!r} limit {lim[k]!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
