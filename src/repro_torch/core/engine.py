"""Unified event-driven serving engine over the platform model and the
device executors.

Port of ``repro/core/engine.py``: the event loop
(:class:`ServingEngine`), the per-class invoker pool, and the device
executors that run Tangram's cloud side - pack crops into slots -> K1
stitch -> ViT detector -> K2 unstitch -> per-frame routing, or, with
``fuse=True``, K4 stitch->embed -> trunk from tokens -> K3 decode->gather
-> per-frame routing, where no canvas batch exists in device memory.

*Engine time* comes from a pluggable clock (:mod:`.clock`).  Three event
kinds, processed in engine-time order: **arrivals** (fed by :meth:`run`,
:meth:`offer` or :meth:`serve`), **invoker timers** (each batcher's
``next_timer()``, fired at the timer's time), and **completions**.  At a
timestamp tie a completion is delivered before a timer fires; two
invokers sharing a timer instant fire in first-registered order.

Executors expose ``submit(inv) -> ExecHandle`` and ``resolve(handle) ->
Completion``.  :class:`SimExecutor` submits to the serverless
``Platform`` model, whose finish time is known at submit;
:class:`DeviceExecutor` joins the device work at submit;
:class:`AsyncDeviceExecutor` returns once the work is queued on the card
and reports readiness through a ``torch.cuda.Event`` recorded after the
launch, probed with ``.query()`` (on the CPU every launch is ready at
once).  ``DeviceExecutor(stream=)`` puts an executor's uploads, kernels,
``done`` event and host copies on a CUDA stream of its own, so the fleet's
shards (:mod:`.fleet`, :mod:`.parallel`) share one card without sharing a
queue.  ``DeviceExecutor(mesh=)`` lays each unfused canvas batch out over
a serve mesh's ``data`` axis (:func:`shard_canvases`: one process drives
every device, the params copied to each once), as the JAX executor lays
it out with a ``NamedSharding``; the fused path does not shard, as in the
reference.  Invocation boundaries depend only on arrivals and the batcher, so
a trace produces the same patch->invocation groupings on all three.  A
:class:`~repro_torch.core.workers.WorkerPoolExecutor` puts several
executors behind the same protocol: handles ready together deliver in
(worker, submit) order, and each worker's finishes are clamped monotone
on their own.  :class:`Results` is a run's record (violations, cost,
batching), as ``core.scheduler`` and ``core.baselines`` assemble it.

Batcher protocol (duck-typed; ``SLOAwareInvoker`` conforms):

    on_patch(t, patch) -> List[Invocation]   # may fire immediately
    poll(t)            -> Optional[Invocation]
    flush(t)           -> Optional[Invocation]  # engine loops until None
    next_timer()       -> float                 # inf when idle
    on_result(inv, t_finish)                    # optional feedback
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compat.shardingx import make_mesh, mesh_axis_sizes
from repro_torch.core import spans
from repro_torch.core.clock import Clock, VirtualClock
from repro_torch.core.framestore import FrameStore
from repro_torch.core.invoker import Invocation, SLOAwareInvoker
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import lookup
from repro_torch.core.stitching import validate
from repro_torch.data.video import Arrival
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stitch import ops as stitch_ops
from repro_torch.param import map_tree
from repro_torch.serverless.platform import Platform
from repro_torch.sharding import DEFAULT_RULES, divisible_spec


# ------------------------------------------------------------- outcomes ----

@dataclasses.dataclass
class PatchOutcome:
    patch: Patch
    t_arrive: float
    t_submit: float
    t_finish: float
    model: Optional[str] = None   # registry model that served the patch

    @property
    def latency(self) -> float:
        return self.t_finish - self.patch.t_gen

    @property
    def violated(self) -> bool:
        return self.t_finish > self.patch.deadline

    @property
    def wait(self) -> float:
        return self.t_submit - self.t_arrive


@dataclasses.dataclass
class Results:
    """One run's record, as every benchmark of the paper reads it: the
    outcomes, the batching, the bytes shipped and the platform's bill.
    ``invocations``, ``total_cost`` and ``exec_seconds`` are the platform
    model's: a run on a device executor leaves them at the platform's
    (empty) meter, as in the JAX package."""
    name: str
    outcomes: List[PatchOutcome]
    canvas_efficiencies: List[float]
    batch_sizes: List[int]
    patches_per_batch: List[int]
    bytes_sent: float
    total_cost: float
    invocations: int
    exec_seconds: float
    transmission_seconds: float
    mean_consolidation: float = 0.0   # patches per invocation (platform view)
    worker_stats: Optional[List[dict]] = None  # per-worker pool counters
                                      # (WorkerPoolExecutor.worker_stats)
    source_stats: Optional[dict] = None  # ingestion-side accounting
                                      # (SourceStats.to_dict(): frames
                                      # dropped/degraded under
                                      # backpressure, arrivals, bytes)
    model_stats: Optional[dict] = None  # per-model platform counters
                                      # (Platform.model_stats())
    shard_stats: Optional[List[dict]] = None  # per-shard fleet rows
                                      # (ShardedEngine.shard_stats)

    @property
    def n_patches(self) -> int:
        return len(self.outcomes)

    @property
    def violation_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(o.violated for o in self.outcomes) / len(self.outcomes)

    def class_violation_rate(self, classify: Callable[[Patch], object],
                             key: object) -> float:
        """Violation rate restricted to one SLO class (mixed-SLO studies)."""
        mine = [o for o in self.outcomes if classify(o.patch) == key]
        if not mine:
            return 0.0
        return sum(o.violated for o in mine) / len(mine)

    @property
    def mean_latency(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(o.latency for o in self.outcomes) / len(self.outcomes)

    @property
    def amortized_latency(self) -> float:
        """Total function execution time amortized per patch (Fig. 14)."""
        if not self.outcomes:
            return 0.0
        return self.exec_seconds / len(self.outcomes)

    def class_breakdown(self) -> dict:
        """Per-SLO-class outcome breakdown (keyed by the patch's SLO)."""
        by: Dict[object, List[PatchOutcome]] = {}
        for o in self.outcomes:
            by.setdefault(o.patch.slo, []).append(o)
        return {
            str(slo): {
                "patches": len(outs),
                "violations": sum(o.violated for o in outs),
                "violation_rate": round(
                    sum(o.violated for o in outs) / len(outs), 4),
                "mean_latency_s": round(
                    sum(o.latency for o in outs) / len(outs), 4),
            }
            for slo, outs in sorted(by.items(), key=lambda kv: str(kv[0]))
        }

    def model_breakdown(self) -> dict:
        """Per-model rows: outcome accounting (violations, latency) merged
        with the platform/cache counters in ``model_stats`` (batches,
        cold starts, weight loads, weight-cache hit rate) — the debugging
        surface for mixed-model runs."""
        by: Dict[str, List[PatchOutcome]] = {}
        for o in self.outcomes:
            if o.model is not None:
                by.setdefault(o.model, []).append(o)
        rows: Dict[str, dict] = {}
        for model, outs in sorted(by.items()):
            rows[model] = {
                "patches": len(outs),
                "violations": sum(o.violated for o in outs),
                "violation_rate": round(
                    sum(o.violated for o in outs) / len(outs), 4),
                "mean_latency_s": round(
                    sum(o.latency for o in outs) / len(outs), 4),
            }
        for model, st in sorted((self.model_stats or {}).items()):
            rows.setdefault(model, {}).update(st)
        return rows

    def summary(self) -> dict:
        out = {
            "name": self.name,
            "patches": self.n_patches,
            "violation_rate": round(self.violation_rate, 4),
            "mean_latency_s": round(self.mean_latency, 4),
            "cost_usd": round(self.total_cost, 6),
            "invocations": self.invocations,
            "bytes_mb": round(self.bytes_sent / 1e6, 3),
            "mean_canvas_eff": round(
                sum(self.canvas_efficiencies)
                / max(len(self.canvas_efficiencies), 1), 4),
            "amortized_latency_s": round(self.amortized_latency, 4),
            "mean_consolidation": round(self.mean_consolidation, 2),
            "class_violations": self.class_breakdown(),
        }
        models = self.model_breakdown()
        if models:
            out["models"] = models
        if self.worker_stats is not None:
            # horizon = span of delivered work; utilization is each
            # worker's busy time over it, so placement-policy skew shows
            # up directly in the benchmark JSON
            horizon = max((o.t_finish for o in self.outcomes), default=0.0)
            out["per_worker"] = [
                dict(ws, utilization=round(ws.get("busy_s", 0.0)
                                           / max(horizon, 1e-12), 4))
                for ws in self.worker_stats
            ]
        if self.source_stats is not None:
            out["source"] = self.source_stats
        if self.shard_stats is not None:
            out["per_shard"] = self.shard_stats
        return out


@dataclasses.dataclass
class Completion:
    """One finished invocation, delivered at ``t_finish`` engine time."""
    invocation: Invocation
    t_finish: float
    record: object = None     # platform ExecutionRecord (SimExecutor)
    outputs: object = None    # (per-frame detections, per-frame pixels)
    worker: int = 0           # pool worker that ran it (0 outside a pool)
    model: Optional[str] = None  # registry model that ran it (filled from
                              # the invocation at delivery when unset)


@dataclasses.dataclass
class ExecHandle:
    """An in-flight invocation, returned by ``Executor.submit``.

    ``t_finish`` is set when the executor knows the finish time at submit
    (a sync device run): the engine then schedules delivery on its heap.
    ``None`` means the work is still on the card; the engine resolves the
    handle when it reports ready, the in-flight bound is hit, or the trace
    drains.  ``worker`` is the pool worker the invocation was placed on (0
    outside a pool) and ``seq`` the engine's submit order: ``(worker,
    seq)`` orders handles that report ready at the same harvest.
    """
    invocation: Invocation
    t_finish: Optional[float] = None
    completion: Optional[Completion] = None
    payload: object = None            # executor-private in-flight state
    worker: int = 0
    seq: int = -1
    model: Optional[str] = None       # invocation's model key (engine-set)
    load_s: float = 0.0               # weight-cache load seconds still to
                                      # add to t_finish at resolve (async
                                      # handles; 0 once applied)


# ----------------------------------------------------------- invoker pool ----

def slo_class(patch: Patch) -> float:
    """Default classification: one invoker per distinct SLO value."""
    return patch.slo


class InvokerPool:
    """Per-class SLO-aware invokers behind one batcher interface.

    ``classify`` maps a patch to its class key; ``make_invoker(key)``
    builds the class's invoker on first use, so each class can have its
    own canvas geometry and latency table.  Fired invocations are tagged
    with their class ``key`` and, when ``model_of`` is given, with the
    registry model its class resolves to (``model_of(key)``).
    """

    def __init__(self, make_invoker: Callable[[object], SLOAwareInvoker],
                 classify: Callable[[Patch], object] = slo_class,
                 model_of: Optional[Callable[[object],
                                             Optional[str]]] = None):
        self.make_invoker = make_invoker
        self.classify = classify
        self.model_of = model_of
        self.invokers: Dict[object, SLOAwareInvoker] = {}

    def _invoker(self, key: object) -> SLOAwareInvoker:
        inv = self.invokers.get(key)
        if inv is None:
            inv = self.invokers[key] = self.make_invoker(key)
        return inv

    def _tag(self, fired, key):
        model = self.model_of(key) if self.model_of is not None else None
        for f in fired:
            f.key = key
            if f.model is None:
                f.model = model
        return fired

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        key = self.classify(patch)
        return self._tag(self._invoker(key).on_patch(t_now, patch), key)

    def queue_depth(self) -> int:
        """Patches currently queued (unfired) across every class."""
        return sum(len(inv.queue) for inv in self.invokers.values())

    def next_timer(self) -> float:
        return min((inv.next_timer() for inv in self.invokers.values()),
                   default=math.inf)

    def poll(self, t_now: float) -> Optional[Invocation]:
        """Fire the due invoker with the earliest timer (ties: the
        first-registered class)."""
        due = [(inv.next_timer(), key) for key, inv in self.invokers.items()
               if inv.next_timer() <= t_now]
        if not due:
            return None
        _, key = min(due, key=lambda x: x[0])
        fired = self.invokers[key].poll(t_now)
        if fired is not None:
            self._tag([fired], key)
        return fired

    def flush(self, t_now: float) -> Optional[Invocation]:
        for key, inv in self.invokers.items():
            fired = inv.flush(t_now)
            if fired is not None:
                self._tag([fired], key)
                return fired
        return None


def uniform_pool(canvas_m: int, canvas_n: int, latency, max_canvases: int = 8,
                 incremental: bool = True,
                 classify: Optional[Callable[[Patch], object]] = None,
                 model_of: Optional[Callable[[object],
                                             Optional[str]]] = None
                 ) -> InvokerPool:
    """Pool where every class shares one geometry/latency spec;
    ``classify=None`` is the paper's single shared queue, ``model_of``
    tags fired invocations with their class's model."""
    return InvokerPool(
        lambda key: SLOAwareInvoker(canvas_m, canvas_n, latency,
                                    max_canvases, incremental=incremental),
        classify=classify or (lambda p: None), model_of=model_of)


# -------------------------------------------------------------- executors ----

class SimExecutor:
    """Executor over the discrete-event serverless ``Platform`` model.

    The model is consulted at submit, so the handle's finish time is
    known immediately and the engine schedules delivery on the event
    heap — the simulation analogue of "the device will interrupt us at
    t_finish".

    Multi-model serving: ``model_loads`` maps a registry model name to its
    weight-load seconds and ``model_tables`` to its latency table.  A
    model-tagged invocation is submitted with its own profile and load
    cost, and the platform's per-model warm pools keep an instance warm
    for one model and cold for another; untagged invocations keep the
    single-model behaviour.
    """

    def __init__(self, platform: Platform,
                 model_loads: Optional[Dict[str, float]] = None,
                 model_tables: Optional[Dict[str, object]] = None):
        self.platform = platform
        self.model_loads = model_loads or {}
        self.model_tables = model_tables or {}

    def submit(self, inv: Invocation) -> ExecHandle:
        size = (inv.cost_canvases if inv.cost_canvases is not None
                else len(inv.canvases))
        if inv.model is None:
            rec = self.platform.submit(inv.t_submit, size,
                                       n_patches=len(inv.patches))
        else:
            rec = self.platform.submit(
                inv.t_submit, size, n_patches=len(inv.patches),
                model=inv.model,
                model_load_s=self.model_loads.get(inv.model, 0.0),
                latency=self.model_tables.get(inv.model))
        comp = Completion(inv, rec.t_finish, record=rec, model=inv.model)
        return ExecHandle(inv, t_finish=rec.t_finish, completion=comp)

    def resolve(self, handle: ExecHandle) -> Completion:
        return handle.completion

    def execute(self, inv: Invocation) -> Completion:  # legacy shim
        return self.resolve(self.submit(inv))


@dataclasses.dataclass
class ModelRuntime:
    """One servable model on the device path: ``serve_fn(params,
    canvases) -> (obj, boxes)``, its params, and its canvas geometry.

    The fused path's fields: ``tokens_fn(params, tokens) -> raw head`` is
    the trunk minus the patch embed, ``embed_kernel`` / ``embed_bias`` the
    patch-embed projection in the compute dtype (K4 applies it), and
    ``patch`` the detector's patch size.

    ``mesh`` (a serve mesh, ``launch/mesh.make_serve_mesh``) lays each
    unfused canvas batch out over its ``data`` axis
    (:func:`shard_canvases`); the params are copied once to each of the
    axis's devices here, when the runtime is built (``replicas``, one a
    ``data`` row; a device listed twice shares one copy).  A
    :class:`DeviceExecutor` serves an unfused runtime given without a mesh
    on its own (a copy of the runtime on it).  ``rules`` is
    the logical-axis table the batch's ``("batch", ...)`` axes resolve
    through (default ``sharding.DEFAULT_RULES``)."""
    serve_fn: Callable
    params: object
    canvas_m: int
    canvas_n: int
    tokens_fn: Optional[Callable] = None
    embed_kernel: Optional[torch.Tensor] = None
    embed_bias: Optional[torch.Tensor] = None
    patch: Optional[int] = None
    mesh: object = None
    rules: object = None
    replicas: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        if self.mesh is None or self.replicas:
            return
        copies = {}
        for dev in data_devices(self.mesh):
            if dev not in copies:
                copies[dev] = map_tree(
                    lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, self.params)
            self.replicas.append(copies[dev])

    def serve_sharded(self, chunks: List[torch.Tensor], n_real: int,
                      device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``serve_fn`` on each chunk of :func:`shard_canvases` with its
        device's replica; ``obj`` and ``boxes`` gathered on ``device``,
        the padded rows dropped (no record references them)."""
        outs = [self.serve_fn(rep, chunk)
                for rep, chunk in zip(self.replicas, chunks)]
        if len(outs) == 1:      # one data device: no pad rows, no gather
            return outs[0]
        obj = torch.cat([o.to(device) for o, _ in outs])[:n_real]
        boxes = torch.cat([b.to(device) for _, b in outs])[:n_real]
        return obj, boxes


def data_devices(mesh) -> List[torch.device]:
    """The devices of a serve mesh's ``data`` axis, in order (its first
    ``model`` column)."""
    names = tuple(mesh.axis_names)
    devs = np.moveaxis(np.asarray(mesh.devices), names.index("data"), 0)
    return [torch.device(d) for d in devs.reshape(devs.shape[0], -1)[:, 0]]


def shard_canvases(canvases: torch.Tensor, mesh, rules=None
                   ) -> Tuple[List[torch.Tensor], bool]:
    """Lay the canvas batch out data-parallel over the serve mesh.

    The batch is padded to a multiple of the "data"-axis size with zero
    canvases (records never reference pad rows, so the detector output
    for them is dropped before routing), then split along the batch axis
    into one chunk a ``data`` device, each copied there (a peer copy;
    none to the executor's own device).  Returns the chunks and whether
    the data axis actually split the batch (False on one device), as the
    JAX function's ``bool(sh.spec) and n_data > 1``.
    """
    n_data = mesh_axis_sizes(mesh).get("data", 1)
    pad = (-canvases.shape[0]) % n_data
    if pad:
        canvases = torch.cat([canvases, canvases.new_zeros(
            (pad,) + tuple(canvases.shape[1:]))])
    spec = divisible_spec(canvases.shape, ("batch", None, None, None),
                          rules or DEFAULT_RULES, mesh)
    if not spec or n_data == 1:
        return [canvases], False
    devs = data_devices(mesh)
    chunks = torch.chunk(canvases, n_data)
    return [c.to(d) for c, d in zip(chunks, devs)], n_data > 1


@dataclasses.dataclass(eq=False)
class StagingBuffer:
    """One host buffer of a :class:`HostStaging` pool: ``host`` (float32,
    pinned on a card), ``array`` its numpy view, and ``event``, recorded
    after the copy that last read it (None off a card)."""
    host: torch.Tensor
    array: np.ndarray
    event: Optional[torch.cuda.Event]


class HostStaging:
    """The host buffers a device executor stages its invocations from,
    reused.

    On a card they are pinned, so the staging copy runs without the
    host, straight from them; off a card they are ordinary host memory and
    the same code runs.  :meth:`take` lends a free buffer, after waiting
    for the copy that last read it; :meth:`give` takes it back.  A buffer
    is allocated, or grown, only when no free one holds what is asked:
    then to the largest ``reserve`` asked so far, so that once the
    largest batch has run as many invocations as are held at once, the
    pool stops allocating.  ``allocs`` counts buffers allocated or grown;
    ``n_buffers`` those the pool owns, lent or free.
    """

    def __init__(self, pin: bool):
        self.pin = pin
        self.free: List[StagingBuffer] = []
        self.allocs = 0
        self.n_buffers = 0
        self.reserve = 0

    def take(self, n: int, reserve: int = 0) -> StagingBuffer:
        """A buffer of at least ``n`` float32 elements."""
        self.reserve = max(self.reserve, reserve, n)
        buf = max(self.free, key=lambda b: b.array.size, default=None)
        if buf is not None:
            self.free.remove(buf)
            if buf.event is not None:
                buf.event.synchronize()
            if buf.array.size >= n:
                return buf
        else:
            self.n_buffers += 1
        self.allocs += 1
        host = torch.empty(self.reserve, dtype=torch.float32,
                           pin_memory=self.pin)
        return StagingBuffer(host, host.numpy(),
                             torch.cuda.Event() if self.pin else None)

    def give(self, buf: StagingBuffer) -> None:
        self.free.append(buf)


class StagedCrops:
    """One invocation's crops: the views of the frames that
    :meth:`DeviceExecutor._crops` cut, which routing hands out as the
    fused path's evidence, and the buffer lent by a :class:`HostStaging`
    pool that they were packed into, held from staging until routing."""

    def __init__(self, pool: HostStaging, buf: StagingBuffer,
                 crops: List[np.ndarray]):
        self.pool, self.buf, self.crops = pool, buf, crops

    def release(self) -> None:
        """Hand the buffer back to its pool."""
        self.pool.give(self.buf)


def crop_evidence(px: np.ndarray, h: int, w: int
                  ) -> Tuple[np.ndarray, bool]:
    """A patch's evidence from its staged crop ``px``: what its padded
    slot's ``[:h, :w]`` reads, and whether it is a view of the frame.

    A float32 view whose extent is the patch's is handed out as it is,
    read-only (the frame stays writeable).  Every other crop gives a
    private float32 array: a frame of another dtype cast as the staging
    buffer casts it, a crop cut short at the frame's edge zero-padded;
    a frame the store no longer held gave zeros of its own already."""
    if px.dtype == np.float32 and px.shape[:2] == (h, w):
        if px.flags.owndata:
            return px, False
        px.flags.writeable = False
        return px, True
    out = np.zeros((h, w, px.shape[2]), np.float32)
    hh, ww = min(h, px.shape[0]), min(w, px.shape[1])
    out[:hh, :ww] = px[:hh, :ww]
    return out, False


class DeviceExecutor:
    """Executor over the real pipeline on one device: crop gather on the
    host -> slots laid out on the device -> K1 stitch -> detector -> K2
    unstitch -> route, joined synchronously at submit (``t_finish`` =
    ``t_submit`` + measured wall time, the quantity the latency table
    estimates).

    Staging ships only the crops' bytes and the records: packed back to
    back into a reused host buffer (:class:`HostStaging`, pinned on a
    card), copied in one non-blocking copy on the executor's stream, and
    laid out into the plan's zero-padded slots on the device.  Counters:
    ``h2d_bytes`` (bytes shipped), ``pinned_allocs`` (staging buffers
    allocated or grown).

    The fused path's evidence is the crops staging cut: each patch's, a
    read-only view of its frame where that equals the padded slot's
    ``[:h, :w]`` bit for bit, else a private float32 copy
    (:func:`crop_evidence`).  The store holds a frame until its last
    patch is delivered and the engine drops a completion's outputs at
    delivery, so there a view holds its frame no longer than the store
    does; a caller that keeps the evidence keeps the whole frame.
    Counters: ``evidence_views``, ``evidence_copies`` (patches routed
    each way; the unfused path copies every patch).

    :meth:`_launch` queues the work and returns before the card finishes;
    :meth:`_finalize` copies the outputs to the host (which waits for the
    card) and routes them.  This class joins the two back to back;
    :class:`AsyncDeviceExecutor` keeps them apart.

    ``impl`` picks the kernels' implementation (``"cuda"`` kernel or
    ``"torch"`` plain version); ``None`` follows the device, so on a card
    the hand kernels run.  ``fuse=True`` runs the fused path (K4 -> trunk
    from tokens -> K3) and needs ``tokens_fn``, ``embed_kernel``,
    ``embed_bias`` and ``patch``: without them construction raises (the
    JAX executor silently falls back to the unfused path, which here would
    hide the kernels).  Owns the refcounted frame store: the engine's
    completion event releases each routed patch's frame.

    Multi-model serving: ``models`` maps a registry model name to a
    :class:`ModelRuntime`, or to a zero-argument callable returning one
    (built on first use and cached).  A model-tagged invocation runs its
    model's runtime; untagged invocations, and tags missing from the
    mapping, run the default runtime of the positional arguments.  With
    ``fuse=True`` every runtime must carry the fused fields: an eager
    entry is checked at construction, a lazy one when it is built.

    ``stream`` (a ``torch.cuda.Stream`` of the executor's device; the
    counterpart of the JAX executor's ``mesh=``): :meth:`_launch`,
    :meth:`_record_done` and :meth:`_finalize` each run inside
    ``torch.cuda.stream(stream)``, so the staging copy, every
    kernel, the trunk, the ``done`` event and the host copies land on it.
    Each method enters the stream itself, because the current stream is
    per thread and one thread may drive several executors.  ``None``
    keeps the thread's current stream.

    ``mesh`` / ``rules``: the serve mesh of every unfused runtime that
    comes without one (:class:`ModelRuntime`; default: the unit mesh of
    ``device``, data=1) and the default runtime's rule table.  An unfused
    invocation splits its canvas batch over its runtime's ``data``
    devices (:func:`shard_canvases`; one device, one chunk) and counts in
    ``n_sharded`` when the axis split it.  Unused with ``fuse=True`` (no
    canvas batch exists).
    """

    def __init__(self, serve_fn, params, canvas_m: int, canvas_n: int, *,
                 device: DeviceLike = None, impl: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 fuse: bool = False, tokens_fn: Optional[Callable] = None,
                 embed_kernel: Optional[torch.Tensor] = None,
                 embed_bias: Optional[torch.Tensor] = None,
                 patch: Optional[int] = None,
                 models: Optional[Dict[str, object]] = None,
                 stream: Optional[torch.cuda.Stream] = None,
                 mesh=None, rules=None):
        if impl is not None and impl not in stitch_ops.IMPLS:
            raise ValueError(f"unknown stitch impl {impl!r}; choose from "
                             f"{list(stitch_ops.IMPLS)}")
        self.fuse = fuse
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            (1, 1), ("data", "model"), devices=[self.device])
        self.runtime = self._checked(
            ModelRuntime(serve_fn, params, canvas_m, canvas_n, tokens_fn,
                         embed_kernel, embed_bias, patch, rules=rules), None)
        self.models = dict(models) if models else {}
        self._runtimes: Dict[Optional[str], ModelRuntime] = {
            None: self.runtime}
        for name, entry in self.models.items():
            if isinstance(entry, ModelRuntime):
                self._runtimes[name] = self._checked(entry, name)
        if stream is not None and not _on_device(stream, self.device):
            raise ValueError(f"stream on {stream.device} for an executor on "
                             f"{self.device}")
        self.stream = stream
        self.impl = impl
        self.clock = clock
        self.store = FrameStore()
        self.n_invocations = 0
        self.n_fused = 0
        self.n_detections = 0
        self.n_sharded = 0
        self.evidence_bytes = 0
        self.evidence_views = 0
        self.evidence_copies = 0
        self.staging = HostStaging(pin=self.device.type == "cuda")
        self.h2d_bytes = 0

    def _checked(self, rt: ModelRuntime, model: Optional[str]
                 ) -> ModelRuntime:
        """``rt`` ready to serve: unfused, on the executor's mesh when it
        came without one; fused, a ValueError when it lacks the fused
        fields or its canvas is not a multiple of its patch."""
        if not self.fuse:
            return rt if rt.mesh is not None else dataclasses.replace(
                rt, mesh=self.mesh, replicas=[])
        what = "the default runtime" if model is None else f"model {model!r}"
        missing = [k for k in ("tokens_fn", "embed_kernel", "embed_bias",
                               "patch") if getattr(rt, k) is None]
        if missing:
            raise ValueError(f"fuse=True needs the fused fields; {what} "
                             f"is missing {missing}")
        if rt.canvas_m % rt.patch or rt.canvas_n % rt.patch:
            raise ValueError(f"fuse=True needs the canvas {rt.canvas_m}x"
                             f"{rt.canvas_n} of {what} to be a multiple of "
                             f"the patch {rt.patch}")
        return rt

    def _runtime(self, model: Optional[str]) -> ModelRuntime:
        """An invocation's model tag -> its runtime (the default for None
        or an unmapped tag); a lazy entry is built once and cached."""
        rt = self._runtimes.get(model)
        if rt is None:
            entry = self.models.get(model)
            rt = (self.runtime if entry is None
                  else self._checked(entry(), model))
            self._runtimes[model] = rt
        return rt

    # ------------------------------------------------------- frame store ----

    def add_frame(self, frame_id, pixels: np.ndarray, n_patches: int):
        """Register a frame the edge cut ``n_patches`` patches from."""
        self.store.add(frame_id, pixels, n_patches)

    def on_complete(self, comp: Completion):
        """Completion event: release every routed patch's frame ref."""
        release = self.store.release
        for p in comp.invocation.patches:
            release(p.frame_id)

    @property
    def frames(self) -> Dict[object, np.ndarray]:
        return self.store.snapshot()

    @property
    def _refs(self) -> Dict[object, int]:
        return self.store.refs_snapshot()

    @property
    def pinned_allocs(self) -> int:
        """Staging buffers allocated or grown (pinned on a card)."""
        return self.staging.allocs

    # --------------------------------------------------------- execution ----

    def _launch(self, inv: Invocation) -> dict:
        """Host-side packing + queueing of the device work; nothing here
        waits for the card.  The payload carries the invocation's span
        number (``inv``; None with no span log)."""
        with torch.cuda.stream(self.stream), spans.span(
                "stage", spans.NEW, len(inv.canvases)) as stage:
            payload = self._queue(inv)
            payload["inv"] = stage.inv
            return payload

    def _queue(self, inv: Invocation) -> dict:
        t0 = self.clock()
        rt = self._runtime(inv.model)
        with spans.span("stage.plan"):
            plan = inv.batch_plan()
            stitch_ops.check_records(plan)
        slots, records, staged = self._stage(inv, plan, rt)
        with spans.span("stage.launch"):
            if self.fuse:
                # K4 emits the token batch straight from the slots, the
                # trunk runs from tokens, and K3 decodes the head into
                # per-slot grids
                tokens = stitch_ops.stitch_embed(
                    slots, records, rt.embed_kernel, rt.embed_bias,
                    rt.canvas_m, rt.canvas_n, rt.patch, impl=self.impl)
                raw = rt.tokens_fn(rt.params, tokens)
                fused = stitch_ops.unstitch_decode(
                    raw, records, rt.patch, plan.slot_capacity,
                    impl=self.impl)
                self.n_invocations += 1
                self.n_fused += 1
                return {"plan": plan, "fused": fused, "staged": staged,
                        "done": self._record_done(fused), "t0": t0}
            canvases = stitch_ops.stitch_canvases(
                slots, records, rt.canvas_m, rt.canvas_n, impl=self.impl)
            chunks, sharded = shard_canvases(canvases, rt.mesh, rt.rules)
            obj, boxes = rt.serve_sharded(chunks, canvases.shape[0],
                                          self.device)
            # inverse gather: the box head has no pixel-space output, so
            # the canvases stand in for a per-pixel head; the gathered
            # slots equal the input crops and are routed back as evidence
            patch_out = stitch_ops.unstitch_patches(
                canvases, records, plan.slot_capacity, plan.hmax, plan.wmax,
                impl=self.impl)
            self.n_invocations += 1
            self.n_sharded += bool(sharded)
            return {"plan": plan, "obj": obj, "boxes": boxes,
                    "patch_out": patch_out, "staged": staged,
                    "done": self._record_done(obj, boxes, patch_out),
                    "t0": t0}

    def _crops(self, inv: Invocation) -> List[np.ndarray]:
        """Each queued patch's crop, a view of its frame; zeros for a frame
        the store no longer holds."""
        crops = []
        store = self.store
        for patch in inv.patches:
            frame = store.get(patch.frame_id)
            if frame is None:
                crops.append(np.zeros((patch.h, patch.w, 3), np.float32))
            else:
                crops.append(frame[patch.y0:patch.y1, patch.x0:patch.x1])
        return crops

    def _stage(self, inv: Invocation, plan, rt: ModelRuntime):
        """The plan's slots and records on the device, from one buffer of
        the staging pool: the records and the crops packed back to back
        with no padding (``stage.pack``), one non-blocking copy on the
        executor's stream, then the padded slots laid out on the device
        (``stage.h2d``, valued in the bytes shipped).  Returns the slots,
        the records and the :class:`StagedCrops` that routing takes the
        fused path's evidence from and releases."""
        records_np = plan.records
        n_rec = records_np.size
        with spans.span("stage.pack"):
            crops = self._crops(inv)
            c = crops[0].shape[-1] if crops else 3
            need = n_rec + c * sum(px.shape[0] * px.shape[1] for px in crops)
            # the most an invocation of this many canvases can ship: its
            # crops lie on the canvases without overlap
            reserve = n_rec + len(records_np) * rt.canvas_m * rt.canvas_n * c
            buf = self.staging.take(need, reserve)
            buf.array[:n_rec].view(np.int32)[:] = records_np.reshape(-1)
            packed = stitch_ops.pack_plan_compact(
                crops, plan, out=buf.array[n_rec:need])
        with spans.span("stage.h2d", value=4 * need):
            flat = buf.host[:need].to(self.device, non_blocking=True,
                                      copy=True)
            if buf.event is not None:
                buf.event.record(torch.cuda.current_stream(self.device))
            records = flat[:n_rec].view(torch.int32).view(records_np.shape)
            slots = stitch_ops.lay_out_slots(flat[n_rec:], packed, plan)
        self.h2d_bytes += 4 * need
        return slots, records, StagedCrops(self.staging, buf, crops)

    def _record_done(self, *outputs):
        """What :meth:`AsyncDeviceExecutor.ready` probes with ``query()``.
        On a card: an event recorded after the queued work, on the
        executor's stream, always.  Off a card: the first output with a
        ``query()`` of its own (a stand-in accelerator's future,
        :mod:`.devicestub`, whose outputs of one call finish together), or
        ``None`` when every output is ready already."""
        if self.device.type == "cuda":
            with torch.cuda.stream(self.stream):
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            return done
        return next((o for o in outputs if hasattr(o, "query")), None)

    def _finalize(self, inv: Invocation, payload: dict) -> Completion:
        """Copy the outputs to the host (waits for the card) and route."""
        with torch.cuda.stream(self.stream):
            return self._route(inv, payload)

    def _route(self, inv: Invocation, payload: dict) -> Completion:
        plan = payload["plan"]
        staged = payload["staged"]
        # the head's host copies are freed before any evidence copy
        # allocates: held across one copy a patch, K3's grids cost
        # tangram-replay about a tenth of its patches a second (measured
        # on an H100 host)
        if "fused" in payload:
            with spans.span("route.wait"):
                grids = payload["fused"].cpu().numpy()
            with spans.span("route.fused"):
                per_frame = stitch_ops.route_fused(plan, inv.patches, grids)
            del grids

            # the unfused evidence (gathered slots) equals the input crops,
            # so the fused path hands out the crops it staged
            def evidence(i, patch):
                return crop_evidence(staged.crops[i],
                                     min(patch.h, plan.hmax),
                                     min(patch.w, plan.wmax))
        else:
            with spans.span("route.wait"):
                obj = payload["obj"].cpu().numpy()
                boxes = payload["boxes"].cpu().numpy()
            with spans.span("route.fused"):
                per_frame = stitch_ops.route_detections(plan, inv.patches,
                                                        obj, boxes)
            del obj, boxes
            with spans.span("route.wait"):
                gathered = payload["patch_out"].cpu().numpy()

            def evidence(i, patch):
                # a copy: a view of the gathered slots would pin the
                # whole batch
                return np.array(gathered[i, :patch.h, :patch.w]), False
        # the host copies waited for the card: the trunk's device-timed
        # spans have ended
        spans.settle(payload.get("inv"))
        per_frame_pixels: Dict[object, List[np.ndarray]] = {}
        views = 0
        with spans.span("route.evidence"):
            for i, patch in enumerate(inv.patches):
                px, view = evidence(i, patch)
                views += view
                per_frame_pixels.setdefault(patch.frame_id, []).append(px)
        self.evidence_views += views
        self.evidence_copies += len(inv.patches) - views
        # the outputs' host copies waited for the card, so the staging
        # copy has read the buffer
        staged.release()
        wall = self.clock() - payload["t0"]

        self.n_detections += sum(len(v) for v in per_frame.values())
        self.evidence_bytes += sum(
            a.nbytes for v in per_frame_pixels.values() for a in v)
        return Completion(inv, inv.t_submit + wall,
                          outputs=(per_frame, per_frame_pixels),
                          model=inv.model)

    def submit(self, inv: Invocation) -> ExecHandle:
        payload = self._launch(inv)
        with spans.span("route", payload["inv"], len(inv.canvases)):
            comp = self._finalize(inv, payload)
            del payload
        return ExecHandle(inv, t_finish=comp.t_finish, completion=comp)

    def resolve(self, handle: ExecHandle) -> Completion:
        if handle.completion is None:
            # the span holds the payload's release
            with spans.span("route", handle.payload["inv"],
                            len(handle.invocation.canvases)):
                handle.completion = self._finalize(handle.invocation,
                                                   handle.payload)
                handle.payload = None
        return handle.completion

    def execute(self, inv: Invocation) -> Completion:  # legacy shim
        return self.resolve(self.submit(inv))


def _on_device(stream, device: torch.device) -> bool:
    """True when ``stream`` belongs to ``device`` (an index-less ``cuda``
    device means the current one)."""
    if device.type != "cuda" or stream.device.type != "cuda":
        return False
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return stream.device.index == index


class AsyncDeviceExecutor(DeviceExecutor):
    """Overlapped device execution: submit returns once the work is queued
    on the card, so the engine keeps ingesting arrivals and restitching
    while the card works through its stream.

    ``max_inflight`` bounds the unresolved handles the engine may hold
    (each pins device memory for its canvases and outputs).  Readiness is
    the ``torch.cuda.Event`` recorded after the launch (``.query()``);
    on the CPU every launch is ready, unless a stand-in accelerator's
    future is still pending (:meth:`DeviceExecutor._record_done`).
    """

    def __init__(self, *args, max_inflight: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight

    def submit(self, inv: Invocation) -> ExecHandle:
        return ExecHandle(inv, t_finish=None, payload=self._launch(inv))

    def ready(self, handle: ExecHandle) -> bool:
        if handle.completion is not None:
            return True
        done = handle.payload["done"]
        return done is None or done.query()


_EXECUTORS = {
    "sim": SimExecutor,
    "device": DeviceExecutor,
    "async_device": AsyncDeviceExecutor,
}


def make_executor(name: str, **cfg):
    """Executor-name -> instance (``sim`` | ``device`` | ``async_device``).
    ``cfg`` forwards to the constructor: ``sim`` takes ``platform=`` (and
    ``model_loads=`` / ``model_tables=``), the device executors the
    pipeline arguments (and ``models=``).  Keys of the other substrate
    (and ``max_inflight`` for the sync executors) are accepted and
    dropped, so one config dict drives any name."""
    cls = lookup("executor", _EXECUTORS, name)
    device_only = {"fuse", "tokens_fn", "embed_kernel", "embed_bias",
                   "patch", "serve_fn", "params", "canvas_m", "canvas_n",
                   "device", "impl", "clock", "models", "stream", "mesh",
                   "rules"}
    sim_only = {"platform", "model_loads", "model_tables"}
    if cls is SimExecutor:
        drop = {"max_inflight"} | device_only
    elif cls is AsyncDeviceExecutor:
        drop = sim_only
    else:
        drop = {"max_inflight"} | sim_only
    return cls(**{k: v for k, v in cfg.items() if k not in drop})


# ------------------------------------------------------------ event loop ----

class ServingEngine:
    """The one event loop.  Feed arrivals; timers and completions fire at
    their scheduled engine times; fired invocations run on the executor.

    ``clock`` defaults to a fresh :class:`VirtualClock`.
    ``ingestion_window`` is an advisory backlog bound, in patches, that
    live sources read through :meth:`overloaded`.
    """

    def __init__(self, pool, executor, clock: Optional[Clock] = None,
                 check_invariants: bool = False,
                 ingestion_window: Optional[int] = None):
        if ingestion_window is not None and ingestion_window < 1:
            raise ValueError(f"ingestion_window must be >= 1, got "
                             f"{ingestion_window}")
        self.pool = pool
        self.executor = executor
        self.clock = clock if clock is not None else VirtualClock()
        self.check_invariants = check_invariants
        self.ingestion_window = ingestion_window
        self.backlog_high_water = 0
        self.outcomes: List[PatchOutcome] = []
        self.invocations: List[Invocation] = []
        self.completions: List[Completion] = []
        # arrival bookkeeping in reused slots, sized to the peak backlog
        self._slot_patch: List[Optional[Patch]] = []
        self._slot_t: List[float] = []
        self._free_slots: List[int] = []
        self._slot_of: Dict[int, int] = {}    # id(patch) -> live slot
        self.arrivals_total = 0
        # incremental backlog counters: offered -> _queued, fired ->
        # _inflight_count, delivered -> retired
        self._queued = 0
        self._inflight_count = 0
        self._ready_probe = getattr(executor, "ready", None)
        self._scheduled: List = []   # heap of (t_finish, seq, ExecHandle)
        self._inflight: collections.deque = collections.deque()
        self._event_seq = 0
        self._last_async_finish: Dict[int, float] = {}   # per worker
        self.inflight_high_water = 0

    @property
    def now(self) -> float:
        """Engine time of the last event processed."""
        return self.clock.now()

    # ----------------------------------------------------------- feeding ----

    def run(self, arrivals: Sequence[Arrival]) -> List[PatchOutcome]:
        """Drive a whole (sorted-by-``t_arrive``) arrival trace to empty."""
        self.offer_batch(arrivals)
        self.finish()
        return self.outcomes

    def serve(self, source) -> List[PatchOutcome]:
        """Pull loop over a :mod:`repro_torch.sources` source, which gets
        this engine as its backpressure handle."""
        for arr in source.events(self):
            self.offer(arr)
        self.finish()
        return self.outcomes

    def offer(self, arrival: Arrival):
        """One arrival: first fire everything due strictly before it."""
        self.advance(arrival.t_arrive)
        self.clock.advance_to(arrival.t_arrive)
        if spans.LOG is not None:
            self._late(arrival.t_arrive, "arrival")
        self._ingest(arrival)

    def offer_batch(self, arrivals: Sequence[Arrival]):
        """:meth:`offer` in a loop, minus the per-arrival event probe when
        nothing is due before the arrival (and no async work is in
        flight, where the per-event harvest matters)."""
        for arr in arrivals:
            if self._ready_probe is not None and self._inflight:
                self.offer(arr)
                continue
            t = arr.t_arrive
            if self._next_event() < t:
                self.advance(t)
            self.clock.advance_to(t)
            if spans.LOG is not None:
                self._late(t, "arrival")
            self._ingest(arr)

    def _ingest(self, arrival: Arrival):
        """Arrival bookkeeping + batcher feed (clock already advanced)."""
        patch = arrival.patch
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_patch[slot] = patch
            self._slot_t[slot] = arrival.t_arrive
        else:
            slot = len(self._slot_patch)
            self._slot_patch.append(patch)
            self._slot_t.append(arrival.t_arrive)
        self._slot_of[id(patch)] = slot
        self.arrivals_total += 1
        self._queued += 1
        for inv in self.pool.on_patch(arrival.t_arrive, patch):
            self._dispatch(inv)
        backlog = self._queued + self._inflight_count
        if backlog > self.backlog_high_water:
            self.backlog_high_water = backlog
        if self.check_invariants:
            depth = getattr(self.pool, "queue_depth", None)
            if depth is not None and self._queued != depth():
                raise AssertionError(f"queued {self._queued} != pool "
                                     f"depth {depth()}")

    def _next_event(self) -> float:
        """Engine time of the next due timer or scheduled completion."""
        t = self.pool.next_timer()
        if self._scheduled:
            t_comp = self._scheduled[0][0]
            if t_comp < t:
                return t_comp
        return t

    # ------------------------------------------------- ingestion window ----

    def queued_patches(self) -> int:
        """Patches accepted but not yet fired (pool queues)."""
        return self._queued

    def inflight_patches(self) -> int:
        """Patches inside unresolved invocations (scheduled + in flight)."""
        return self._inflight_count

    def backlog(self) -> int:
        """Unfinished patches (queued + in flight), O(1)."""
        return self._queued + self._inflight_count

    def overloaded(self) -> bool:
        """True when the backlog has filled the ingestion window."""
        return (self.ingestion_window is not None
                and self.backlog() >= self.ingestion_window)

    def advance(self, t: float):
        """Process every timer/completion event scheduled before ``t``;
        at a tie the completion is delivered first."""
        while True:
            self._harvest_ready()
            t_timer = self.pool.next_timer()
            t_comp = self._scheduled[0][0] if self._scheduled else math.inf
            t_next = min(t_timer, t_comp)
            if t_next >= t:
                return
            self.clock.advance_to(t_next)
            if spans.LOG is not None:
                self._late(t_next, "completion" if t_comp <= t_timer
                           else "timer")
            if t_comp <= t_timer:
                self._deliver_scheduled()
            else:
                fired = self.pool.poll(t_timer)
                if fired is None:       # defensive: a policy may decline
                    return
                self._dispatch(fired)

    def finish(self, t_end: Optional[float] = None):
        """Drain timers at their scheduled times, flush stragglers, and
        deliver every remaining completion."""
        self.advance(math.inf)
        t = self.now if t_end is None else t_end
        while True:
            fired = self.pool.flush(t)
            if fired is None:
                break
            self._dispatch(fired)
        while self._inflight:
            self._resolve_one()
        while self._scheduled:
            self.clock.advance_to(self._scheduled[0][0])
            self._deliver_scheduled()

    # --------------------------------------------------------- internals ----

    def _late(self, due: float, kind: str):
        """``engine.late``: the event due at engine time ``due``, taken
        now, as an interval that ends now on the span log's clock and
        lasts the lag in engine seconds (zero when on time).  Only on a
        wall clock: a virtual one is never late."""
        log = spans.LOG
        if log is None or self.clock.virtual:
            return
        t1 = log.clock()
        lag = max(0.0, self.clock.now() - due)
        log.event("engine.late", t1 - lag, t1, value=kind)

    def _dispatch(self, inv: Invocation):
        spans.event("fire", value=inv.reason)
        # canvas-less invocations are legitimate only for batchers that
        # bill through cost_canvases (the padded-tile baselines)
        if self.check_invariants and inv.cost_canvases is None:
            validate(inv.canvases)
            placed = sorted(p.patch_idx for c in inv.canvases
                            for p in c.placements)
            if placed != list(range(len(inv.patches))):
                raise AssertionError(f"patches not placed once: {placed}")
        self.invocations.append(inv)
        n = len(inv.patches)
        self._queued -= n
        self._inflight_count += n
        bound = getattr(self.executor, "max_inflight", None)
        if bound is not None:
            # make room before submitting: take any finished handle first,
            # block on the oldest only when none is
            while len(self._inflight) >= bound:
                self._resolve_one()
        handle = self.executor.submit(inv)
        self._event_seq += 1
        handle.seq = self._event_seq
        if handle.model is None:
            handle.model = inv.model
        if handle.t_finish is not None:
            heapq.heappush(self._scheduled,
                           (handle.t_finish, self._event_seq, handle))
        else:
            self._inflight.append(handle)
            self.inflight_high_water = max(self.inflight_high_water,
                                           len(self._inflight))

    @staticmethod
    def _delivery_order(handle: ExecHandle):
        """Handles ready at the same harvest deliver in (worker index,
        submit seq) order, so multi-worker replays are reproducible."""
        return (handle.worker, handle.seq)

    def _harvest_ready(self):
        """Deliver async completions the card has already finished
        (non-blocking; every in-flight handle is probed, so a slow batch
        on one worker does not hold back finished ones on another)."""
        ready = self._ready_probe
        if ready is None:
            return
        while True:
            done = [h for h in self._inflight if ready(h)]
            if not done:
                return
            for handle in sorted(done, key=self._delivery_order):
                self._inflight.remove(handle)
                self._resolve_inflight(handle)

    def _resolve_one(self):
        """Retire one in-flight handle: the lowest (worker, seq) ready
        one, else block on the FIFO head."""
        ready = self._ready_probe
        if ready is not None:
            done = [h for h in self._inflight if ready(h)]
            if done:
                handle = min(done, key=self._delivery_order)
                self._inflight.remove(handle)
                self._resolve_inflight(handle)
                return
        self._resolve_inflight(self._inflight.popleft())

    def _resolve_inflight(self, handle: ExecHandle):
        comp = self.executor.resolve(handle)
        # a worker is a serial queue, so its finishes are clamped monotone;
        # across workers finishes interleave, and one clamp for all would
        # invent violations for a fast worker delivered after a slow one
        last = self._last_async_finish.get(handle.worker, 0.0)
        comp.t_finish = max(last, comp.t_finish)
        self._last_async_finish[handle.worker] = comp.t_finish
        self._deliver(comp)

    def _deliver_scheduled(self):
        _, _, handle = heapq.heappop(self._scheduled)
        self._deliver(self.executor.resolve(handle))

    def _deliver(self, comp: Completion):
        """Completion delivery: executor bookkeeping, outcome recording,
        then batcher feedback - all observing the actual finish."""
        on_complete = getattr(self.executor, "on_complete", None)
        if on_complete is not None:
            on_complete(comp)
        inv = comp.invocation
        if comp.model is None:
            comp.model = inv.model
        self._inflight_count -= len(inv.patches)
        for p in inv.patches:
            slot = self._slot_of.pop(id(p), None)
            if slot is None:
                t_arrive = inv.t_submit
            else:
                t_arrive = self._slot_t[slot]
                self._slot_patch[slot] = None
                self._free_slots.append(slot)
            self.outcomes.append(
                PatchOutcome(p, t_arrive, inv.t_submit, comp.t_finish,
                             model=comp.model))
        on_result = getattr(self.pool, "on_result", None)
        if on_result is not None:
            on_result(inv, comp.t_finish)
        # on_complete is the delivery point for outputs; dropping them
        # keeps the retained completion log light
        comp.outputs = None
        self.completions.append(comp)
