"""Serving driver: the Tangram pipeline on the device, through the port.

Port of ``repro/launch/serve.py`` but for fleet sharding (``--shards``,
``--parallel``, ``--planner``: ROADMAP item 11).  Edge side per frame:
GMM background subtraction -> RoI extraction -> adaptive frame
partitioning (Alg. 1).  Cloud side: the serving engine drives the
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
``--quantize`` serves int8-resident trunk weights (registry models
resolve to their ``_int8`` variants).

``--model`` / ``--model-map CLASS=MODEL`` serve registry models
(:mod:`~repro_torch.core.models`), each built at ``--canvas`` and
profiled on its own, so each SLO class fires against its model's table.
``--workers N`` serves through a
:class:`~repro_torch.core.workers.WorkerPoolExecutor` of N async
executors (worker ``i`` on ``cuda:(i % device count)``; on one card they
share it) placed by ``--placement``; ``--online-latency`` folds every
completion's time back into the tables the invokers fire against.
``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
PyTorch versions of the kernels.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --frames 40 --slo 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 5.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 0.5,2.0 --model-map 0.5=vit_s16 \
    --model-map 2.0=tangram --workers 2 --placement model --online-latency
  PYTHONPATH=src python -m repro_torch.launch.serve --source file \
    --frames-path clip.npy --frames 16 --canvas 1024 --fuse
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import param
from repro_torch.config import DetectorConfig
from repro_torch.core.clock import make_clock
from repro_torch.core import config as config_lib
from repro_torch.core.config import ServeConfig, make_classify
from repro_torch.core.engine import (InvokerPool, ModelRuntime,
                                     ServingEngine, make_executor,
                                     uniform_pool)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable, measure)
from repro_torch.core.models import make_model, model_names
from repro_torch.core.workers import (WorkerPoolExecutor, device_worker_pool,
                                      make_placement, weight_caches,
                                      worker_device)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import detector as detector_lib
from repro_torch.models.quantize import quantize_params
from repro_torch.sources import RateProfile, make_source

#: options of the JAX driver this port does not run yet -> ROADMAP item
UNPORTED = dict(config_lib.UNPORTED)


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


def fused_fields(cfg, params) -> dict:
    """A detector's fused-path fields (of :class:`ModelRuntime` and the
    executor): the trunk from tokens and the patch-embed projection K4
    applies."""
    kernel, bias = detector_lib.embed_params(cfg, params)
    return dict(tokens_fn=detector_lib.tokens_fn(cfg), embed_kernel=kernel,
                embed_bias=bias, patch=cfg.patch)


def fused_kwargs(cfg, params) -> dict:
    """The executor's keyword arguments for the fused path."""
    return dict(fuse=True, **fused_fields(cfg, params))


def runtimes(builds: dict, m: int, n: int, fuse: bool) -> dict:
    """One :class:`ModelRuntime` a built model (``name -> (cfg, params,
    serve_fn)``), with the fused fields when ``fuse``."""
    return {name: ModelRuntime(fn, pr, m, n,
                               **(fused_fields(mcfg, pr) if fuse else {}))
            for name, (mcfg, pr, fn) in builds.items()}


def on_device(builds: dict, device: torch.device) -> dict:
    """``builds`` with their parameters on ``device`` (a worker on another
    card); the same dict when they already are."""
    def move(build):
        cfg, params, fn = build
        return cfg, param.map_tree(lambda t: t.to(device), params), fn
    if all(t.device == device for _, pr, _ in builds.values()
           for t in param.leaves(pr)):
        return builds
    return {name: move(b) for name, b in builds.items()}


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
    if config.n_workers > 1:
        overlap = (f"{config.n_workers} worker(s), {config.placement} "
                   f"placement, in-flight high water "
                   f"{engine.inflight_high_water}/"
                   f"{getattr(executor, 'max_inflight', '-')}")
    elif config.executor == "async_device":
        overlap = (f"async, in-flight high water "
                   f"{engine.inflight_high_water}/{config.max_inflight}")
    else:
        overlap = "sync"
    if config.online_latency:
        overlap += ", online latency"
    if config.fuse:
        overlap += ", fused"
    if config.quantize:
        overlap += ", int8"
    device = (executor.workers[0].device
              if isinstance(executor, WorkerPoolExecutor)
              else executor.device)
    violated = sum(o.violated for o in engine.outcomes)
    return (f"served {stats.patches_emitted} patches in "
            f"{executor.n_invocations} invocations ({overlap}, "
            f"{config.clock} clock, {device}), "
            f"routed {executor.n_detections} detections + "
            f"{executor.evidence_bytes / 1e6:.2f} MB patch evidence back to "
            f"frames, {violated} SLO violations "
            f"({len(executor.frames)} frames still held, {wall_s:.1f}s wall)")


def detail_lines(engine: ServingEngine, executor) -> list:
    """A pool's per-worker rows and the per-model rows (patches,
    violations, weight-cache hits)."""
    lines = []
    if isinstance(executor, WorkerPoolExecutor):
        for ws in executor.worker_stats():
            drift = f", drift {ws['drift']}x" if "drift" in ws else ""
            lines.append(f"  worker {ws['worker']}: {ws['invocations']} "
                         f"invocations, {ws['patches']} patches, "
                         f"busy {ws['busy_s']:.3f}s{drift}")
    by_model = {}
    for o in engine.outcomes:
        if o.model is not None:
            row = by_model.setdefault(o.model, [0, 0])
            row[0] += 1
            row[1] += int(o.violated)
    cache_stats = (executor.model_cache_stats()
                   if hasattr(executor, "model_cache_stats") else {})
    for name in sorted(by_model):
        served, viol = by_model[name]
        extra = ""
        cs = cache_stats.get(name)
        if cs:
            extra = (f", weight hits {cs['weight_hits']}/"
                     f"{cs['weight_hits'] + cs['weight_misses']}")
        lines.append(f"  model {name}: {served} patches, "
                     f"{viol} violations{extra}")
    return lines


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
    p.add_argument("--workers", type=int, default=1,
                   help="worker pool size: this many async executors, "
                        "worker i on cuda:(i %% device count), concurrent "
                        "invocations routed across them by --placement")
    p.add_argument("--placement",
                   choices=("least", "round", "affinity", "model"),
                   default="least",
                   help="worker placement with --workers > 1: least "
                        "outstanding, round robin, class affinity (the "
                        "tightest SLO class gets worker 0 once a second "
                        "class appears) or model affinity (batches of one "
                        "model co-locate so its weights stay resident)")
    p.add_argument("--model", default=None,
                   help="registry model to serve (repro_torch.core.models; "
                        "default: the built-in detector)")
    p.add_argument("--model-map", action="append", default=None,
                   metavar="CLASS=MODEL",
                   help="route an SLO class to a registry model, e.g. "
                        "--model-map 0.5=vit_s16 --model-map 2.0=tangram; "
                        "repeatable; unmapped classes fall back to --model")
    p.add_argument("--online-latency", action="store_true",
                   help="fold each completion's time back into the latency "
                        "tables the invokers fire against (EWMA)")
    # JAX driver options this port does not run yet: accepted so the
    # error names the ROADMAP item instead of an unknown flag
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--planner", choices=("cost", "equal"))
    args = p.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: {item}")
    if args.workers < 1:
        p.error("--workers must be >= 1")
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
    model_map = None
    if args.model_map:
        try:
            model_map = dict(kv.split("=", 1) for kv in args.model_map)
        except ValueError:
            p.error("--model-map entries must look like CLASS=MODEL")
    device = resolve_device(args.device)

    config = ServeConfig(
        max_canvases=4,
        classify="slo" if (model_map or len(slos) > 1) else None,
        executor="async_device" if args.async_device or args.workers > 1
        else "device",
        fuse=args.fuse, quantize=args.quantize, source=args.source,
        max_inflight=args.max_inflight, clock=args.clock,
        wall_speed=args.wall_speed, n_workers=args.workers,
        placement=args.placement, online_latency=args.online_latency,
        ingestion_window=args.ingestion_window, model=args.model,
        model_map=model_map)
    if config.quantize and config.multi_model:
        # every named model with a registered _int8 variant serves it
        have = set(model_names())

        def _q(name):
            return f"{name}_int8" if name and f"{name}_int8" in have else name

        config = config.replace(
            model=_q(config.model),
            model_map=({k: _q(v) for k, v in config.model_map.items()}
                       if config.model_map else None))
    m = n = args.canvas
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    if config.multi_model:
        # each named model built at the CLI canvas (its reduced trunk),
        # weights seeded by its name
        specs = {nm: make_model(nm) for nm in config.model_names()}
        builds = {nm: spec.build(canvas=args.canvas, device=device)
                  for nm, spec in specs.items()}
        default_model = config.model or sorted(builds)[0]
        cfg, params, serve_fn = builds[default_model]
        print(f"models: {', '.join(sorted(builds))} "
              f"(default {default_model})")
    else:
        specs, builds, default_model = {}, {}, None
        cfg, params, serve_fn = build_detector(
            args.canvas, quantize=config.quantize, device=device)
    # the tables profile the unfused serve_fn on canvases, as
    # repro.launch.serve does for both paths; one a model
    table = profile(serve_fn, params, m, n, device)
    print("latency table:", {k: (round(mu, 4), round(sd, 4))
                             for k, (mu, sd) in table.table.items()})
    model_tables = {nm: (table if nm == default_model
                         else profile(fn, pr, m, n, device))
                    for nm, (_, pr, fn) in builds.items()}
    estimator = None
    if config.online_latency:
        # one estimator, shared by the invokers (t_slack) and the pool
        # (observations); with models a LatencyBank of one a model
        table = OnlineLatencyTable(table)
        model_tables = {nm: (table if nm == default_model
                             else OnlineLatencyTable(t))
                        for nm, t in model_tables.items()}
        estimator = (LatencyBank(model_tables) if config.multi_model
                     else table)
    caches = None
    if config.multi_model and len(specs) > 1:
        # each worker holds the largest single model, so swaps are real
        caches = weight_caches(
            config.n_workers, max(s.weight_bytes for s in specs.values()),
            {nm: (s.weight_bytes, s.load_s) for nm, s in specs.items()})

    def executor_on(dev: torch.device):
        """One worker's executor on ``dev``, every model's runtime with it."""
        here = on_device({**builds, None: (cfg, params, serve_fn)}, dev)
        dcfg, dparams, dfn = here.pop(None)
        return make_executor(
            config.executor, serve_fn=dfn, params=dparams, canvas_m=m,
            canvas_n=n, device=dev, max_inflight=config.max_inflight,
            models=runtimes(here, m, n, config.fuse) if here else None,
            **(fused_kwargs(dcfg, dparams) if config.fuse else {}))

    t_start = time.time()
    if config.n_workers > 1:
        executor = device_worker_pool(
            config.n_workers, lambda i: executor_on(worker_device(i, device)),
            placement=make_placement(config.placement),
            estimator=estimator, weight_caches=caches)
    else:
        executor = executor_on(device)
        if config.online_latency or caches is not None:
            # a one-worker pool adds only the estimator's feedback and the
            # weight-cache accounting; the executor keeps its mode
            executor = WorkerPoolExecutor([executor], estimator=estimator,
                                          weight_caches=caches)
    source = build_source(args, frame_sink=executor.add_frame, slos=slos,
                          device=device)
    classify = make_classify(config.classify)
    if config.multi_model:
        # per-class invokers, each firing against its model's table
        def make_invoker(key):
            nm = config.resolve_model(key) or default_model
            return SLOAwareInvoker(m, n, model_tables[nm],
                                   max_canvases=config.max_canvases)

        pool = InvokerPool(make_invoker, classify=classify or (lambda p: None),
                           model_of=lambda key: (config.resolve_model(key)
                                                 or default_model))
    else:
        pool = uniform_pool(m, n, table, max_canvases=config.max_canvases,
                            classify=classify)
    engine = ServingEngine(
        pool, executor, clock=make_clock(config.clock,
                                         speed=config.wall_speed),
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
    for line in detail_lines(engine, executor):
        print(line)

if __name__ == "__main__":
    main()
