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

Worker pools, online latency tables and multi-model serving (ROADMAP
item 10) and fleet sharding (item 11) are not ported: a config that asks
for them raises ``NotImplementedError`` naming the item.  The pre-config
keyword arguments (``max_canvases=``, ``adaptive=``, ...) still work
through a deprecation shim that warns once and forwards onto the config.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

from repro_torch.core.adaptive import adaptive_uniform_pool
from repro_torch.core.clock import Clock, make_clock
from repro_torch.core.config import UNPORTED, ServeConfig, make_classify
from repro_torch.core.engine import (PatchOutcome, Results, ServingEngine,
                                     SimExecutor, uniform_pool)
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.serverless.platform import Platform, mean_consolidation
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
        # callable or a Clock instance, which a config cannot express,
        # becomes a direct override of the named reference.
        classify_override: Optional[Callable[[Patch], object]] = None
        clock_override: Optional[Clock] = None
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
                else:
                    fields[name] = value
            config = config.replace(**fields)

        for field in ("n_workers", "placement", "online_latency", "model",
                      "model_map", "shards"):
            value = getattr(config, field)
            if value and not (field == "n_workers" and value == 1):
                raise _unported(field, value)
        self.config = config
        classify = (classify_override if classify_override is not None
                    else make_classify(config.classify))
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
        # a ctor-supplied executor is used as it is; the platform then
        # carries only the cost meter
        executor = (self._executor_override
                    if self._executor_override is not None
                    else SimExecutor(self.platform))
        engine = ServingEngine(self.pool, executor,
                               clock=self._clock(),
                               check_invariants=self.check_invariants,
                               ingestion_window=self.config.ingestion_window)
        outcomes = engine.serve(source)

        stats = source.stats()
        source_stats = stats.to_dict()
        source_stats["backlog_high_water"] = engine.backlog_high_water
        source_stats["ingestion_window"] = self.config.ingestion_window
        records = self.platform.records
        model_stats = records_model_stats(records)
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
            source_stats=source_stats,
            model_stats=model_stats or None)
