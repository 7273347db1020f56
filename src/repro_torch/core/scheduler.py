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
(one a model, in a ``LatencyBank``) fed by every completion.  Fleet
sharding (``shards``, ROADMAP item 11) is not ported: the scheduler
refuses it naming the item.  The pre-config keyword arguments
(``max_canvases=``, ``adaptive=``, ...) still work through a deprecation
shim that warns once and forwards onto the config.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

from repro_torch.core.adaptive import (AdaptiveInvokerPool,
                                       adaptive_uniform_pool)
from repro_torch.core.clock import Clock, make_clock
from repro_torch.core.config import UNPORTED, ServeConfig, make_classify
from repro_torch.core.engine import (InvokerPool, PatchOutcome, Results,
                                     ServingEngine, SimExecutor,
                                     uniform_pool)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable)
from repro_torch.core.models import make_model
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import unknown_name
from repro_torch.core.workers import WorkerPoolExecutor, make_placement
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


def _unported(field: str, value) -> NotImplementedError:
    return NotImplementedError(f"ServeConfig.{field}={value!r} is not "
                               f"ported yet: {UNPORTED[field]}")


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

        if config.shards is not None:
            raise _unported("shards", config.shards)
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
            if config.adaptive is not None:
                self.pool = AdaptiveInvokerPool(
                    make_invoker, pool_classify, config.adaptive,
                    model_of=config.resolve_model)
            else:
                self.pool = InvokerPool(make_invoker, pool_classify,
                                        model_of=config.resolve_model)
        else:
            if config.online_latency:
                latency = self.estimator = OnlineLatencyTable(latency)
            if config.adaptive is not None:
                self.pool = adaptive_uniform_pool(
                    canvas_m, canvas_n, latency, config.max_canvases,
                    incremental=config.incremental, classify=classify,
                    cfg=config.adaptive)
            else:
                self.pool = uniform_pool(
                    canvas_m, canvas_n, latency, config.max_canvases,
                    incremental=config.incremental, classify=classify)
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

    def serve_source(self, source, name: str = "tangram") -> Results:
        """Serve any :mod:`repro_torch.sources` source end to end and
        assemble the ``Results`` record (bandwidth and drop/degrade
        accounting from ``source.stats()``)."""
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
