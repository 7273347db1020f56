"""Tangram scheduler: a thin adapter over the unified serving engine.

Port of the single-engine path of ``repro/core/scheduler.py``.  It wires
the engine to the paper's scenario (bandwidth-shaped arrivals ->
SLO-aware batching -> serverless platform) and assembles the
:class:`~repro_torch.core.engine.Results` record every benchmark of the
paper reads (violation rate, cost, invocations)::

    sched = TangramScheduler(256, 256, table, Platform(table),
                             config=ServeConfig(classify="slo"))
    results = sched.run(streams, bandwidth_bps=40e6)

By default fired invocations run on a :class:`SimExecutor` over the
platform model.  A ctor-supplied ``executor`` (e.g. a
:class:`~repro_torch.core.engine.DeviceExecutor` on the card) is used as
it is; the platform then only carries the cost meter, so the record's
cost and platform invocations read 0, as in the JAX package.

``config.model`` / ``model_map`` serve registry models
(:mod:`~repro_torch.core.models`): each class's invoker takes its model's
canvas geometry and latency table, and fired invocations carry the
model's name to the executor, the placement and the platform's per-model
warm pools.  ``config.n_workers > 1`` or ``online_latency`` run a
:class:`~repro_torch.core.workers.WorkerPoolExecutor` over platform
shards, with an :class:`~repro_torch.core.latency.OnlineLatencyTable`
(one a model, in a ``LatencyBank``) fed by every completion.
``config.shards`` serves through a
:class:`~repro_torch.core.fleet.ShardedEngine` (``parallel=True``: a
:class:`~repro_torch.core.parallel.ParallelShardedEngine`, a thread a
shard) laid out by ``config.planner``, and fills ``Results.shard_stats``.
The pre-config keyword arguments (``max_canvases=``, ``adaptive=``, ...)
still work through a deprecation shim that warns once and forwards onto
the config.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

from repro_torch.core.adaptive import (AdaptiveInvokerPool,
                                       adaptive_uniform_pool)
from repro_torch.core.clock import Clock, make_clock
from repro_torch.core.config import ServeConfig, make_classify
from repro_torch.core.engine import (InvokerPool, PatchOutcome, Results,
                                     ServingEngine, SimExecutor,
                                     uniform_pool)
from repro_torch.core.fleet import (FleetCostModel, FleetInvokerPool,
                                    FleetPlan, ShardedEngine,
                                    fleet_uniform_pool, make_planner)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable)
from repro_torch.core.models import make_model
from repro_torch.core.parallel import ParallelShardedEngine
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import unknown_name
from repro_torch.core.workers import (ReservedClassPlacement,
                                      WorkerPoolExecutor, make_placement)
from repro_torch.serverless.platform import (Platform, mean_consolidation,
                                             split_platform)
from repro_torch.serverless.platform import model_stats as records_model_stats

__all__ = ["PatchOutcome", "Results", "ServeConfig", "TangramScheduler"]

#: legacy keyword -> ServeConfig field (the deprecation shim's mapping)
_LEGACY_FIELDS = ("max_canvases", "check_invariants", "classify",
                  "incremental", "adaptive", "clock", "n_workers",
                  "placement", "online_latency", "ingestion_window")
_legacy_warned = False


def _warn_legacy_once(names):
    global _legacy_warned
    if _legacy_warned:
        return
    _legacy_warned = True
    warnings.warn(
        f"TangramScheduler keyword arguments {sorted(names)} are "
        f"deprecated; pass config=ServeConfig(...) instead "
        f"(repro_torch.core.config)", DeprecationWarning, stacklevel=3)


class TangramScheduler:
    """The cloud-side scheduler of Fig. 5.

    ``config.classify=None`` keeps the paper's single shared queue;
    ``"slo"`` shards the invoker per SLO class.  ``config.clock="virtual"``
    (default) gives every run a fresh virtual clock (simulation).
    """

    def __init__(self, canvas_m: int, canvas_n: int, latency: LatencyTable,
                 platform: Platform,
                 config: Optional[ServeConfig] = None,
                 executor: object = None, **legacy):
        config = config if config is not None else ServeConfig()
        self._executor_override = executor
        # Old keyword arguments forward onto the config; a classify
        # callable, a Clock or a placement instance, which a config cannot
        # express, becomes a direct override of the named reference.
        classify_override: Optional[Callable[[Patch], object]] = None
        clock_override: Optional[Clock] = None
        placement_override: object = None
        if legacy:
            unknown = set(legacy) - set(_LEGACY_FIELDS)
            if unknown:
                raise TypeError(
                    f"unexpected TangramScheduler arguments "
                    f"{sorted(unknown)}")
            _warn_legacy_once(legacy)
            fields = {}
            for name, value in legacy.items():
                if name == "classify" and callable(value):
                    classify_override = value
                elif name == "clock" and isinstance(value, Clock):
                    clock_override = value
                elif name == "placement" and not (
                        value is None or isinstance(value, str)):
                    placement_override = value
                else:
                    fields[name] = value
            config = config.replace(**fields)

        self.config = config
        classify = (classify_override if classify_override is not None
                    else make_classify(config.classify))
        self.estimator = None          # OnlineLatencyTable | LatencyBank
        self._model_specs: dict = {}
        self._model_tables: dict = {}  # base tables (platform sampling)
        if config.multi_model:
            # each class's invoker takes its model's canvas geometry and
            # latency table off the registry spec; the ctor's canvas and
            # latency are the single-model fallback and unused here
            specs = {n: make_model(n) for n in config.model_names()}
            self._model_specs = specs
            base = {n: (s.table if s.table is not None
                        else s.latency_table())
                    for n, s in specs.items()}
            self._model_tables = base
            if config.online_latency:
                online = {n: OnlineLatencyTable(t) for n, t in base.items()}
                self.estimator = LatencyBank(online)
                invoker_tables = online
            else:
                invoker_tables = dict(base)

            def make_invoker(key):
                model = config.resolve_model(key)
                if model is None:
                    raise unknown_name("SLO class", key,
                                       config.model_map or {})
                spec = specs[model]
                return SLOAwareInvoker(spec.canvas_m, spec.canvas_n,
                                       invoker_tables[model],
                                       config.max_canvases,
                                       incremental=config.incremental)

            pool_classify = classify or (lambda p: None)

            def make_pool(fleet: bool = False):
                # adaptive pools keep the stock scan in a fleet too (the
                # heap pool decides the same, only faster)
                if config.adaptive is not None:
                    return AdaptiveInvokerPool(
                        make_invoker, pool_classify, config.adaptive,
                        model_of=config.resolve_model)
                cls = FleetInvokerPool if fleet else InvokerPool
                return cls(make_invoker, pool_classify,
                           model_of=config.resolve_model)
        else:
            if config.online_latency:
                latency = self.estimator = OnlineLatencyTable(latency)

            def make_pool(fleet: bool = False):
                if config.adaptive is not None:
                    return adaptive_uniform_pool(
                        canvas_m, canvas_n, latency, config.max_canvases,
                        incremental=config.incremental, classify=classify,
                        cfg=config.adaptive)
                fn = fleet_uniform_pool if fleet else uniform_pool
                return fn(canvas_m, canvas_n, latency, config.max_canvases,
                          incremental=config.incremental, classify=classify)
        self._make_pool = make_pool
        self.pool = make_pool()
        # the planner's cost model reads one latency table; with models,
        # the first registry model's (the planner wants a trend)
        self._planner_table = (next(iter(self._model_tables.values()))
                               if self._model_tables else latency)
        self.platform = platform
        self.n_workers = config.n_workers
        self.placement = (placement_override
                          if placement_override is not None
                          else make_placement(config.placement)
                          if config.placement is not None else None)
        self.clock = clock_override
        self.check_invariants = config.check_invariants

    def _clock(self) -> Optional[Clock]:
        """A legacy clock instance wins; otherwise "virtual" keeps the
        engine default (a fresh VirtualClock per engine) and "wall"
        builds a fresh wall clock per run."""
        if self.clock is not None:
            return self.clock
        if self.config.clock == "virtual":
            return None
        return make_clock(self.config.clock, speed=self.config.wall_speed)

    def _shard_clocks(self, n: int) -> list:
        """One clock a shard.  Sequential: ``n`` independent
        :meth:`_clock` results.  Parallel: "virtual" stays ``None`` (each
        engine builds a private virtual clock), and a wall clock fans out
        into thread-private :meth:`~repro_torch.core.clock.WallClock.
        shard_view` s of one timeline."""
        if not self.config.parallel:
            return [self._clock() for _ in range(n)]
        base = self._clock()
        if base is None:
            return [None] * n
        if hasattr(base, "shard_view"):
            return [base.shard_view() for _ in range(n)]
        return [base] + [self._clock() for _ in range(n - 1)]  # legacy

    def _sim_executor(self, platform: Platform) -> SimExecutor:
        """A SimExecutor over ``platform``; with models, each model's
        submissions carry its weight-load seconds and sample its own base
        latency table."""
        if not self._model_specs:
            return SimExecutor(platform)
        loads = {n: s.load_s for n, s in self._model_specs.items()}
        return SimExecutor(platform, model_loads=loads,
                           model_tables=self._model_tables)

    def _executor(self):
        """A ctor-supplied executor as it is (the platform then carries
        only the cost meter); else one SimExecutor, or a worker pool over
        platform shards (one shared cost meter) when ``n_workers > 1`` or
        an estimator needs the completions."""
        if self._executor_override is not None:
            return self._executor_override, [self.platform]
        if self.n_workers == 1 and self.estimator is None:
            return self._sim_executor(self.platform), [self.platform]
        platforms = (split_platform(self.platform, self.n_workers)
                     if self.n_workers > 1 else [self.platform])
        pool = WorkerPoolExecutor([self._sim_executor(p) for p in platforms],
                                  placement=self.placement,
                                  estimator=self.estimator)
        return pool, platforms

    def run(self, streams: Sequence[Sequence[Patch]], bandwidth_bps: float,
            name: str = "tangram") -> Results:
        """Replay per-camera patch streams over shaped uplinks: a
        :class:`~repro_torch.sources.TraceSource` through
        :meth:`serve_source`."""
        from repro_torch.sources import TraceSource
        return self.serve_source(
            TraceSource(streams=streams, bandwidth_bps=bandwidth_bps),
            name=name)

    # ------------------------------------------------------ fleet sharding ----

    def _fleet_plan(self, source) -> FleetPlan:
        """The layout for ``config.shards`` shards.  A source with
        ``camera_rates()`` (``FleetCameraSource``) feeds the planner;
        otherwise routing is ``camera_id % shards`` with the worker budget
        split evenly."""
        config = self.config
        s = config.shards
        budget = max(config.n_workers, s)
        rates = (source.camera_rates()
                 if hasattr(source, "camera_rates") else None)
        if not rates:
            per, extra = divmod(budget, s)
            return FleetPlan(n_shards=s,
                             workers=tuple(per + (1 if i < extra else 0)
                                           for i in range(s)))
        planner = make_planner(
            config.planner or "cost",
            cost_model=FleetCostModel(latency=self._planner_table),
            worker_budget=budget)
        class_rates = (source.class_rates()
                       if hasattr(source, "class_rates") else None)
        return planner.plan(rates, class_rates=class_rates, n_shards=s)

    def _serve_sharded(self, source, name: str) -> Results:
        """The ``config.shards`` path of :meth:`serve_source`: plan the
        layout, build one engine a shard over its platform slice (worker
        sub-pools honour the plan's per-class reservations), serve through
        a :class:`ShardedEngine` (or its parallel twin), and fold the
        per-shard rows into ``Results.shard_stats``.  As in the reference,
        the shards run on simulated executors."""
        config = self.config
        plan = self._fleet_plan(source)
        s_count = plan.n_shards
        weights = [max(plan.workers_of(s), 1) for s in range(s_count)]
        shard_platforms = (split_platform(self.platform, s_count,
                                          weights=weights)
                           if s_count > 1 else [self.platform])
        window = (max(1, config.ingestion_window // s_count)
                  if config.ingestion_window else None)
        engines, platforms = [], []
        clocks = self._shard_clocks(s_count)
        for s in range(s_count):
            w = plan.workers_of(s)
            plat = shard_platforms[s]
            if w > 1:
                worker_plats = split_platform(plat, w)
                reserved = (plan.reservations[s]
                            if plan.reservations else {})
                placement = (ReservedClassPlacement(reserved) if reserved
                             else self.placement)
                executor = WorkerPoolExecutor(
                    [self._sim_executor(p) for p in worker_plats],
                    placement=placement, estimator=self.estimator)
                platforms.extend(worker_plats)
            else:
                executor = self._sim_executor(plat)
                platforms.append(plat)
            engines.append(ServingEngine(
                self._make_pool(fleet=True), executor, clock=clocks[s],
                check_invariants=self.check_invariants,
                ingestion_window=window))
        engine_cls = (ParallelShardedEngine if config.parallel
                      else ShardedEngine)
        sharded = engine_cls(engines, plan.shard_of, plan=plan)
        outcomes = sharded.serve(source)

        stats = source.stats()
        source_stats = stats.to_dict()
        source_stats["backlog_high_water"] = sharded.backlog_high_water
        source_stats["ingestion_window"] = config.ingestion_window
        records = [r for p in platforms for r in p.records]
        invocations = sharded.invocations
        return Results(
            name=name, outcomes=outcomes,
            canvas_efficiencies=[c.efficiency for inv in invocations
                                 for c in inv.canvases],
            batch_sizes=[len(inv.canvases) for inv in invocations],
            patches_per_batch=[len(inv.patches) for inv in invocations],
            bytes_sent=stats.bytes_sent,
            total_cost=self.platform.total_cost,
            invocations=len(records),
            exec_seconds=self.platform.meter.busy_seconds,
            transmission_seconds=stats.transmission_seconds,
            mean_consolidation=mean_consolidation(records),
            source_stats=source_stats,
            model_stats=records_model_stats(records) or None,
            shard_stats=sharded.shard_stats())

    def serve_source(self, source, name: str = "tangram") -> Results:
        """Serve any :mod:`repro_torch.sources` source end to end and
        assemble the ``Results`` record (bandwidth and drop/degrade
        accounting from ``source.stats()``)."""
        if self.config.shards is not None:
            return self._serve_sharded(source, name)
        executor, platforms = self._executor()
        engine = ServingEngine(self.pool, executor,
                               clock=self._clock(),
                               check_invariants=self.check_invariants,
                               ingestion_window=self.config.ingestion_window)
        outcomes = engine.serve(source)

        stats = source.stats()
        source_stats = stats.to_dict()
        source_stats["backlog_high_water"] = engine.backlog_high_water
        source_stats["ingestion_window"] = self.config.ingestion_window
        records = [r for p in platforms for r in p.records]
        model_stats = records_model_stats(records)
        cache_stats = (executor.model_cache_stats()
                       if hasattr(executor, "model_cache_stats") else {})
        for model, row in cache_stats.items():
            model_stats.setdefault(model, {}).update(row)
        return Results(
            name=name, outcomes=outcomes,
            canvas_efficiencies=[c.efficiency for inv in engine.invocations
                                 for c in inv.canvases],
            batch_sizes=[len(inv.canvases) for inv in engine.invocations],
            patches_per_batch=[len(inv.patches)
                               for inv in engine.invocations],
            bytes_sent=stats.bytes_sent,
            total_cost=self.platform.total_cost,
            invocations=len(records),
            exec_seconds=self.platform.meter.busy_seconds,
            transmission_seconds=stats.transmission_seconds,
            mean_consolidation=mean_consolidation(records),
            worker_stats=(executor.worker_stats()
                          if isinstance(executor, WorkerPoolExecutor)
                          else None),
            source_stats=source_stats,
            model_stats=model_stats or None)
