"""Serving driver: the Tangram pipeline on the device, through the port.

Port of ``repro/launch/serve.py``.  Edge side per frame:
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
``--shards N`` serves the cameras through N shard engines
(:class:`~repro_torch.core.fleet.ShardedEngine`; ``--parallel``: a thread
a shard, :class:`~repro_torch.core.parallel.ParallelShardedEngine`), each
with its own executor and, on a card, a CUDA stream of its own, all
sharing one frame store; ``--planner`` places the cameras when the source
reports their rates, else camera ``c`` goes to shard ``c % N``.
``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels.

The devices are laid out as the JAX driver lays them out: one serve mesh
over every device (``launch/mesh.make_serve_mesh``), or one slice a
worker or shard (``make_worker_meshes``), each unfused canvas batch split
over its slice's ``data`` axis (``core/engine.shard_canvases``).  The
devices are the CUDA devices, or one CPU with ``--device cpu``;
:func:`main` also takes a list of devices from its caller (a test passes
eight CPU devices, the port's stand-in for the JAX driver's eight fake
host devices).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --frames 40 --slo 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 5.0
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 0.5,2.0 --model-map 0.5=vit_s16 \
    --model-map 2.0=tangram --workers 2 --placement model --online-latency
  PYTHONPATH=src python -m repro_torch.launch.serve --source file \
    --frames-path clip.npy --frames 16 --canvas 1024 --fuse
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
    --frames 16 --canvas 128 --slo 5.0 --cameras 3 --shards 2 --parallel
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import param
from repro_torch.config import DetectorConfig
from repro_torch.core.clock import make_clock
from repro_torch.core.config import ServeConfig, make_classify
from repro_torch.core.engine import (InvokerPool, ModelRuntime,
                                     ServingEngine, data_devices,
                                     make_executor, shard_canvases,
                                     uniform_pool)
from repro_torch.core.fleet import (FleetCostModel, FleetInvokerPool,
                                    FleetPlan, ShardedEngine,
                                    fleet_uniform_pool, make_planner)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable, measure)
from repro_torch.core.models import make_model, model_names
from repro_torch.core.parallel import ParallelShardedEngine
from repro_torch.core.workers import (WorkerPoolExecutor, device_worker_pool,
                                      make_placement, share_frame_store,
                                      weight_caches)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.launch.mesh import make_serve_mesh, make_worker_meshes
from repro_torch.models import detector as detector_lib
from repro_torch.models.quantize import quantize_params
from repro_torch.sources import RateProfile, make_source


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


def runtimes(builds: dict, m: int, n: int, fuse: bool, mesh=None) -> dict:
    """One :class:`ModelRuntime` a built model (``name -> (cfg, params,
    serve_fn)``), with the fused fields when ``fuse``, else on ``mesh``."""
    return {name: ModelRuntime(fn, pr, m, n,
                               **(fused_fields(mcfg, pr) if fuse
                                  else dict(mesh=mesh)))
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
            batch_sizes=(1, 2, 4), iters: int = 5, mesh=None
            ) -> LatencyTable:
    """Offline profiling (the paper's 1000-iteration stage, scaled down),
    synchronising the device inside each timed call, under the
    data-parallel layout execution will use: ``mesh``, else the unit serve
    mesh of ``device``."""
    mesh = mesh if mesh is not None else make_serve_mesh(devices=[device])
    rt = ModelRuntime(serve_fn, params, m, n, mesh=mesh)

    def run_batch(b):
        x = torch.zeros((b, m, n, 3), device=device)
        chunks, _ = shard_canvases(x, mesh)
        return rt.serve_sharded(chunks, b, device)

    def sync():
        for d in set(data_devices(mesh)):
            synchronize(d)
    return measure(run_batch, batch_sizes=batch_sizes, iters=iters,
                   warmup=1, sync=sync)


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


def shard_stream(device: torch.device):
    """A shard executor's own CUDA stream on a card; ``None`` (the
    thread's current stream) on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def sharded_engine(config: ServeConfig, executors, make_pool, source,
                   table):
    """The ``--shards`` engine over one executor a shard: a fleet invoker
    pool each (``make_pool(fleet=True)``), per-shard clocks (thread-private
    views of one wall timeline under ``--parallel --clock wall``), and the
    planner's layout when the source reports camera rates, else
    ``camera_id % shards``."""
    n = config.shards
    window = (max(1, config.ingestion_window // n)
              if config.ingestion_window else None)
    if config.parallel and config.clock == "wall":
        parent = make_clock("wall", speed=config.wall_speed)
        clocks = [parent.shard_view() for _ in range(n)]
    else:
        clocks = [make_clock(config.clock, speed=config.wall_speed)
                  for _ in range(n)]
    engines = [ServingEngine(make_pool(fleet=True), executors[s],
                             clock=clocks[s], ingestion_window=window)
               for s in range(n)]
    if hasattr(source, "camera_rates"):
        planner = make_planner(config.planner or "cost",
                               cost_model=FleetCostModel(latency=table),
                               worker_budget=n)
        plan = planner.plan(source.camera_rates(), n_shards=n)
    else:
        plan = FleetPlan(n_shards=n)
    cls = ParallelShardedEngine if config.parallel else ShardedEngine
    return cls(engines, plan.shard_of, plan=plan)


def summary_line(engine, executor, stats, config: ServeConfig,
                 wall_s: float, n_data: int = 1) -> str:
    """The driver's one-line run summary (the JAX driver's text);
    ``executor`` is a list of the shards' executors under ``--shards``;
    ``n_data`` the serve mesh's ``data`` axis."""
    executors = (list(executor) if isinstance(executor, (list, tuple))
                 else [executor])
    first = executors[0]
    if config.shards:
        overlap = (f"{config.shards} shard(s), "
                   f"{config.planner or 'cost'} planner"
                   + (", parallel" if config.parallel else ""))
    elif config.n_workers > 1:
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
    violated = sum(o.violated for o in engine.outcomes)

    def total(attr: str) -> int:
        return sum(getattr(e, attr) for e in executors)

    return (f"served {stats.patches_emitted} patches in "
            f"{total('n_invocations')} invocations ({overlap}, "
            f"{config.clock} clock, {total('n_sharded')} data-parallel over "
            f"data={n_data}), "
            f"routed {total('n_detections')} detections + "
            f"{total('evidence_bytes') / 1e6:.2f} MB patch evidence back to "
            f"frames, {violated} SLO violations "
            f"({len(first.frames)} frames still held, {wall_s:.1f}s wall)")


def shard_lines(engine) -> list:
    """A sharded engine's per-shard rows (none for one engine)."""
    if not isinstance(engine, ShardedEngine):
        return []
    return [f"  shard {row['shard']}: {row['arrivals']} arrivals, "
            f"{row['invocations']} invocations, {row['violations']} "
            f"violations, backlog high water {row['backlog_high_water']}"
            for row in engine.shard_stats()]


def detail_lines(engine, executor) -> list:
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


def main(argv=None, devices=None):
    """The CLI.  ``devices`` (a list of ``torch.device``s, repeats
    allowed) replaces the devices ``--device`` names: the serve mesh, or
    the worker / shard slices, are laid over them."""
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
    p.add_argument("--shards", type=int, default=None,
                   help="fleet sharding: serve the cameras through this "
                        "many shard engines, each with its own executor "
                        "(on a card, its own CUDA stream) and invoker pool")
    p.add_argument("--planner", choices=("cost", "equal"), default=None,
                   help="shard layout with --shards when the source "
                        "reports camera rates: cost-model planner or equal "
                        "split (default cost); otherwise camera c goes to "
                        "shard c %% shards")
    p.add_argument("--parallel", action="store_true",
                   help="run each shard's event loop on its own thread "
                        "(requires --shards)")
    args = p.parse_args(argv)
    if args.workers < 1:
        p.error("--workers must be >= 1")
    if args.shards is not None and args.shards < 1:
        p.error("--shards must be >= 1")
    if args.shards is not None and args.workers > 1:
        p.error("--shards and --workers > 1 both carve the device set; "
                "pick one (per-shard worker pools: use the sim scheduler)")
    if args.parallel and args.shards is None:
        p.error("--parallel requires --shards")
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
    if devices is None:
        devices = ([resolve_device("cpu")] if args.device == "cpu"
                   else None)            # every CUDA device (or raise)
    else:
        devices = [resolve_device(d) for d in devices]

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
        model_map=model_map, shards=args.shards, planner=args.planner,
        parallel=args.parallel)
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
    n_slices = config.shards or config.n_workers
    meshes = (make_worker_meshes(n_slices, devices) if n_slices > 1
              else [make_serve_mesh(devices=devices)])
    mesh = meshes[0]
    device = data_devices(mesh)[0]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    print(f"serve mesh: {len(meshes)} worker(s) x data={n_data} "
          f"model={n_model} ({mesh.size} devices each)")
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
    table = profile(serve_fn, params, m, n, device, mesh=mesh)
    print("latency table:", {k: (round(mu, 4), round(sd, 4))
                             for k, (mu, sd) in table.table.items()})
    model_tables = {nm: (table if nm == default_model
                         else profile(fn, pr, m, n, device, mesh=mesh))
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

    def executor_on(mesh_i, stream_of=None):
        """One worker's (or shard's) executor on its mesh slice (on the
        slice's first device), every model's runtime with it."""
        dev = data_devices(mesh_i)[0]
        here = on_device({**builds, None: (cfg, params, serve_fn)}, dev)
        dcfg, dparams, dfn = here.pop(None)
        return make_executor(
            config.executor, serve_fn=dfn, params=dparams, canvas_m=m,
            canvas_n=n, device=dev, max_inflight=config.max_inflight,
            models=(runtimes(here, m, n, config.fuse, mesh_i) if here
                    else None),
            stream=stream_of(dev) if stream_of else None, mesh=mesh_i,
            **(fused_kwargs(dcfg, dparams) if config.fuse else {}))

    t_start = time.time()
    shard_executors = None
    if config.shards:
        # one executor a shard, each on its worker device and its own
        # stream; one frame store, since any shard may route a frame
        shard_executors = [executor_on(meshes[i % len(meshes)], shard_stream)
                           for i in range(config.shards)]
        share_frame_store(shard_executors)
        # the weights were written on the current stream: let them land
        # before another stream reads them
        for d in {d for mh in meshes for d in data_devices(mh)}:
            synchronize(d)
        executor = shard_executors[0]
    elif config.n_workers > 1:
        executor = device_worker_pool(
            config.n_workers, lambda i: executor_on(meshes[i]),
            placement=make_placement(config.placement),
            estimator=estimator, weight_caches=caches)
    else:
        executor = executor_on(mesh)
        if config.online_latency or caches is not None:
            # a one-worker pool adds only the estimator's feedback and the
            # weight-cache accounting; the executor keeps its mode
            executor = WorkerPoolExecutor([executor], estimator=estimator,
                                          weight_caches=caches)
    source = build_source(args, frame_sink=executor.add_frame, slos=slos,
                          device=device)
    classify = make_classify(config.classify)

    def make_pool(fleet: bool = False):
        if config.multi_model:
            # per-class invokers, each firing against its model's table
            def make_invoker(key):
                nm = config.resolve_model(key) or default_model
                return SLOAwareInvoker(m, n, model_tables[nm],
                                       max_canvases=config.max_canvases)

            cls = FleetInvokerPool if fleet else InvokerPool
            return cls(make_invoker, classify=classify or (lambda p: None),
                       model_of=lambda key: (config.resolve_model(key)
                                             or default_model))
        fn = fleet_uniform_pool if fleet else uniform_pool
        return fn(m, n, table, max_canvases=config.max_canvases,
                  classify=classify)

    if config.shards:
        engine = sharded_engine(config, shard_executors, make_pool, source,
                                table)
    else:
        engine = ServingEngine(
            make_pool(), executor, clock=make_clock(config.clock,
                                                    speed=config.wall_speed),
            ingestion_window=config.ingestion_window)
    engine.serve(source)
    stats = source.stats()
    print(summary_line(engine, shard_executors or executor, stats, config,
                       time.time() - t_start, n_data))
    for line in shard_lines(engine):
        print(line)
    print(f"source {stats.kind}: {stats.frames_total} frames, "
          f"{stats.frames_dropped} dropped, {stats.frames_degraded} "
          f"degraded, backlog high water {engine.backlog_high_water}"
          + (f"/{config.ingestion_window}"
             if config.ingestion_window else ""))
    for line in detail_lines(engine, executor):
        print(line)

if __name__ == "__main__":
    main()
