"""Serving driver: the Tangram pipeline on one device, through the port.

Port of the single-executor branch of ``repro/launch/serve.py``.  Edge
side per frame: GMM background subtraction -> RoI extraction -> adaptive
frame partitioning (Alg. 1).  Cloud side: the serving engine drives the
SLO-aware invoker pool over bandwidth-shaped arrivals and runs every fired
invocation on the device pipeline - K1 stitch -> ViT detector -> K2
unstitch -> per-frame routing, or with ``--fuse`` K4 stitch->embed ->
trunk from tokens -> K3 decode->gather -> per-frame routing.

``--source trace`` (default) runs the edge pipeline up front and replays
the arrivals; ``--source synthetic`` runs ``--cameras`` live cameras
during serving, throttled per ``--overload`` against
``--ingestion-window``; ``--source file`` streams the recording at
``--frames-path`` (any frame size, 4K included) through the same live
edge pipeline.  On the card every camera's GMM update is K5.
``--async-device`` overlaps device work with ingestion
(:class:`~repro_torch.core.engine.AsyncDeviceExecutor`).
``--quantize`` serves the detector's trunk int8-resident.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch versions of
the kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --frames 40 --slo 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 5.0
  PYTHONPATH=src python -m repro_torch.launch.serve --source file \
    --frames-path clip.npy --frames 16 --canvas 1024 --fuse
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import DetectorConfig
from repro_torch.core.clock import make_clock
from repro_torch.core import config as config_lib
from repro_torch.core.config import ServeConfig, make_classify
from repro_torch.core.engine import (ServingEngine, make_executor,
                                     uniform_pool)
from repro_torch.core.latency import LatencyTable, measure
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import detector as detector_lib
from repro_torch.models.quantize import quantize_params
from repro_torch.sources import RateProfile, make_source

#: options of the JAX driver this port does not run yet -> ROADMAP item
UNPORTED = {("workers" if field == "n_workers" else field): item
            for field, item in config_lib.UNPORTED.items()}


def build_detector(canvas: int = 256, *, quantize: bool = False,
                   device: DeviceLike = None):
    """The driver's small built-in detector (the JAX driver's dims),
    weights from a ``torch.Generator`` seeded with 0; ``quantize`` serves
    the same weights int8-resident (quantized through
    ``models/quantize.py``).  Returns ``(cfg, params, serve_fn)``."""
    cfg = DetectorConfig(name="serve-det", canvas=canvas, patch=32,
                         n_layers=2, d_model=64, n_heads=4, d_ff=128,
                         param_dtype="float32", compute_dtype="float32")
    params = detector_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                      resolve_device(device))
    if quantize:
        cfg = dataclasses.replace(cfg, quant_weights=True)
        params = quantize_params(detector_lib.param_specs(cfg), params)
    return cfg, params, detector_lib.serve_fn(cfg)


def fused_kwargs(cfg, params) -> dict:
    """The executor's fused-path fields for one detector: the trunk from
    tokens and the patch-embed projection K4 applies."""
    kernel, bias = detector_lib.embed_params(cfg, params)
    return dict(fuse=True, tokens_fn=detector_lib.tokens_fn(cfg),
                embed_kernel=kernel, embed_bias=bias, patch=cfg.patch)


def profile(serve_fn, params, m: int, n: int, device: torch.device,
            batch_sizes=(1, 2, 4), iters: int = 5) -> LatencyTable:
    """Offline profiling (the paper's 1000-iteration stage, scaled down),
    synchronising the device inside each timed call."""
    def run_batch(b):
        return serve_fn(params, torch.zeros((b, m, n, 3), device=device))
    return measure(run_batch, batch_sizes=batch_sizes, iters=iters,
                   warmup=1, sync=lambda: synchronize(device))


def build_source(args, frame_sink, slos, device: torch.device):
    """CLI -> source through ``make_source``.  ``trace`` runs the camera
    pipeline eagerly and replays its arrivals; several ``--slo`` values
    run one camera per class merged into one trace."""
    common = dict(n_frames=args.frames, canvas=args.canvas, slo=slos[0],
                  bandwidth_bps=args.bandwidth_mbps * 1e6,
                  overload=args.overload, frame_sink=frame_sink,
                  rate=RateProfile(fps=args.fps), device=device)
    if args.source == "file":
        return make_source("file", path=args.frames_path, **common)
    live = dict(scene=args.scene, n_cameras=args.cameras, **common)
    if args.source == "synthetic":
        return make_source("synthetic", **live)
    if len(slos) == 1:
        cam = make_source("synthetic", **live)
        return make_source("trace", arrivals=list(cam.events(None)))
    events = []
    for i, slo in enumerate(slos):
        per = dict(live, slo=slo, scene=args.scene + i, n_cameras=1,
                   camera_id=i)
        events.extend(make_source("synthetic", **per).events(None))
    events.sort(key=lambda a: a.t_arrive)
    return make_source("trace", arrivals=events)


def summary_line(engine: ServingEngine, executor, stats, config: ServeConfig,
                 wall_s: float) -> str:
    """The driver's one-line run summary."""
    if config.executor == "async_device":
        overlap = (f"async, in-flight high water "
                   f"{engine.inflight_high_water}/{config.max_inflight}")
    else:
        overlap = "sync"
    if config.fuse:
        overlap += ", fused"
    if config.quantize:
        overlap += ", int8"
    violated = sum(o.violated for o in engine.outcomes)
    return (f"served {stats.patches_emitted} patches in "
            f"{executor.n_invocations} invocations ({overlap}, "
            f"{config.clock} clock, {executor.device}), "
            f"routed {executor.n_detections} detections + "
            f"{executor.evidence_bytes / 1e6:.2f} MB patch evidence back to "
            f"frames, {violated} SLO violations "
            f"({len(executor.frames)} frames still held, {wall_s:.1f}s wall)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--slo", default="1.0",
                   help="SLO seconds; a comma list (e.g. 0.5,2.0) runs one "
                        "camera per class and shards the invoker per SLO")
    p.add_argument("--canvas", type=int, default=256)
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--bandwidth-mbps", type=float, default=40.0,
                   help="uplink shaping for the virtual arrival clock")
    p.add_argument("--source", choices=("trace", "synthetic", "file"),
                   default="trace",
                   help="trace replays a pre-generated edge run; synthetic "
                        "ingests live from --cameras synthetic cameras; "
                        "file streams --frames-path")
    p.add_argument("--cameras", type=int, default=1)
    p.add_argument("--frames-path",
                   help="recorded frame stack for --source file "
                        "(.npy/.npz or a directory of .npy frames)")
    p.add_argument("--ingestion-window", type=int, default=None,
                   help="backlog bound, in patches, that live sources "
                        "throttle against (advisory; default: unbounded)")
    p.add_argument("--overload", choices=("drop", "degrade", "none"),
                   default="drop")
    p.add_argument("--use-pallas-stitch", action="store_true",
                   help="accepted for compatibility with the JAX driver: "
                        "on a CUDA device the hand-written stitch/unstitch "
                        "kernels always run, on the CPU their plain "
                        "PyTorch versions")
    p.add_argument("--async-device", action="store_true",
                   help="overlap device execution with arrival ingestion")
    p.add_argument("--max-inflight", type=int, default=4)
    p.add_argument("--clock", choices=("virtual", "wall"), default="virtual")
    p.add_argument("--wall-speed", type=float, default=1.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--fuse", action="store_true",
                   help="fused path: K4 stitch->embed and K3 "
                        "decode->gather, no canvas batch on the card")
    p.add_argument("--quantize", action="store_true",
                   help="serve int8-resident trunk weights (the built-in "
                        "detector's weights quantized through "
                        "models/quantize.py)")
    # JAX driver options this port does not run yet: accepted so the
    # error names the ROADMAP item instead of an unknown flag
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--placement",
                   choices=("least", "round", "affinity", "model"))
    p.add_argument("--planner", choices=("cost", "equal"))
    p.add_argument("--online-latency", action="store_true")
    p.add_argument("--model", default=None)
    p.add_argument("--model-map", action="append", default=None)
    args = p.parse_args(argv)
    for flag, item in UNPORTED.items():
        value = getattr(args, flag)
        if value and not (flag == "workers" and value == 1):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: {item}")
    if args.cameras < 1:
        p.error("--cameras must be >= 1")
    if args.source == "file" and not args.frames_path:
        p.error("--source file requires --frames-path")
    try:
        slos = [float(s) for s in str(args.slo).split(",")]
    except ValueError:
        p.error(f"--slo must be a float or comma list, got {args.slo!r}")
    if len(slos) > 1 and args.source != "trace":
        p.error("multiple --slo classes need --source trace")
    device = resolve_device(args.device)

    config = ServeConfig(
        max_canvases=4, classify="slo" if len(slos) > 1 else None,
        executor="async_device" if args.async_device else "device",
        fuse=args.fuse, quantize=args.quantize, source=args.source,
        max_inflight=args.max_inflight, clock=args.clock,
        wall_speed=args.wall_speed, ingestion_window=args.ingestion_window)
    m = n = args.canvas
    cfg, params, serve_fn = build_detector(args.canvas,
                                           quantize=config.quantize,
                                           device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    # the table profiles the unfused serve_fn on canvases, as
    # repro.launch.serve does for both paths
    table = profile(serve_fn, params, m, n, device)
    print("latency table:", {k: (round(mu, 4), round(sd, 4))
                             for k, (mu, sd) in table.table.items()})

    t_start = time.time()
    executor = make_executor(config.executor, serve_fn=serve_fn,
                             params=params, canvas_m=m, canvas_n=n,
                             device=device, max_inflight=config.max_inflight,
                             **(fused_kwargs(cfg, params) if config.fuse
                                else {}))
    source = build_source(args, frame_sink=executor.add_frame, slos=slos,
                          device=device)
    engine = ServingEngine(
        uniform_pool(m, n, table, max_canvases=config.max_canvases,
                     classify=make_classify(config.classify)),
        executor, clock=make_clock(config.clock, speed=config.wall_speed),
        ingestion_window=config.ingestion_window)
    engine.serve(source)
    stats = source.stats()
    print(summary_line(engine, executor, stats, config,
                       time.time() - t_start))
    print(f"source {stats.kind}: {stats.frames_total} frames, "
          f"{stats.frames_dropped} dropped, {stats.frames_degraded} "
          f"degraded, backlog high water {engine.backlog_high_water}"
          + (f"/{config.ingestion_window}"
             if config.ingestion_window else ""))


if __name__ == "__main__":
    main()
