"""Online SLO-aware Batching Invoker (Algorithm 2, lines 1-23).

Port of ``repro/core/invoker.py`` (plain Python).  On every patch arrival
the queue is restitched, the Latency Estimator gives the conservative
batch time T_slack, and the invocation instant is
``t_remain = t_DDL - T_slack`` (Eqn. 8).  The invoker fires at
``t_remain`` (timer), or immediately, dispatching the *previous* canvases,
when adding the new patch would make the earliest deadline unmeetable or
overflow function memory; the new patch seeds the next queue.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import (BatchPlan, Canvas, PackState,
                                        build_batch_plan, stitch)


@dataclasses.dataclass
class Invocation:
    t_submit: float
    canvases: List[Canvas]
    patches: List[Patch]
    t_slack: float
    reason: str                 # timer | slo_pressure | memory | late | flush
    plan: Optional[BatchPlan] = None   # built lazily by batch_plan()
    key: object = None          # SLO class, when fired via an InvokerPool
    cost_canvases: Optional[float] = None  # billing override (baselines)
    model: Optional[str] = None  # registry model name (None: the
                                # implicit single model)
    shard: Optional[int] = None  # fleet shard that fired it (tagged by
                                # ShardedEngine; None outside a fleet)

    @property
    def batch_size(self) -> int:
        return len(self.canvases)

    def batch_plan(self) -> BatchPlan:
        """The device-ready multi-canvas plan for this invocation."""
        if self.plan is None:
            m = self.canvases[0].m if self.canvases else 1
            n = self.canvases[0].n if self.canvases else 1
            self.plan = build_batch_plan(self.patches, self.canvases, m, n)
        return self.plan


class SLOAwareInvoker:
    """One SLO class's batching queue.

    ``incremental=True`` keeps the guillotine free-rect state live across
    arrivals (``PackState``); ``incremental=False`` restitches the whole
    queue on every arrival, the paper's literal semantics.  ``margin`` is
    extra firing slack subtracted from ``t_remain`` (0.0 reproduces
    Eqn. 8).
    """

    def __init__(self, canvas_m: int, canvas_n: int, latency: LatencyTable,
                 max_canvases: int = 8, incremental: bool = True,
                 margin: float = 0.0):
        self.m, self.n = canvas_m, canvas_n
        self.latency = latency
        self.max_canvases = max_canvases
        self.margin = margin
        self.incremental = incremental
        self.queue: List[Patch] = []
        self.canvases: List[Canvas] = []
        self.t_remain: float = math.inf
        self._pack = PackState(canvas_m, canvas_n)
        self._t_ddl: float = math.inf      # running min deadline over queue

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        """Lines 4-18.  Returns invocations fired by this arrival."""
        fired: List[Invocation] = []

        n_after, packed = self._probe_canvases(patch)
        t_remain_after = (min(self._t_ddl, patch.deadline)
                          - self.latency.t_slack(n_after) - self.margin)

        if t_remain_after < t_now or n_after > self.max_canvases:
            reason = ("memory" if n_after > self.max_canvases
                      else "slo_pressure")
            if self.queue:
                # dispatch the live packing untouched; the new patch seeds
                # the next queue
                fired.append(Invocation(
                    t_now, self.canvases, self.queue,
                    self.latency.t_slack(len(self.canvases)), reason))
                self._clear()
            self._append(patch)
            if self.t_remain < t_now:
                # a lone patch that still cannot meet its SLO: fire ASAP
                fired.append(self._fire(t_now, "late"))
        else:
            self._append(patch, packed)
        return fired

    def poll(self, t_now: float) -> Optional[Invocation]:
        """Lines 19-22: the timer alignment check."""
        if self.queue and t_now >= self.t_remain:
            return self._fire(max(t_now, self.t_remain), "timer")
        return None

    def flush(self, t_now: float) -> Optional[Invocation]:
        if self.queue:
            return self._fire(t_now, "flush")
        return None

    def next_timer(self) -> float:
        return self.t_remain if self.queue else math.inf

    def _probe_canvases(self, patch: Patch):
        """Canvas count of ``stitch(queue + [patch])`` without committing;
        returns ``(count, packed)`` (``packed`` only from-scratch)."""
        if not self.incremental:
            packed = stitch(self.queue + [patch], self.m, self.n)
            return len(packed), packed
        if patch.w > self.n or patch.h > self.m:
            raise ValueError(
                f"patch ({patch.w}x{patch.h}) exceeds canvas "
                f"({self.n}x{self.m})")
        return (len(self.canvases)
                + (0 if self._pack.fits(patch.w, patch.h) else 1)), None

    def _append(self, patch: Patch, packed=None):
        """Commit one arrival into the queue and the packing state."""
        self.queue.append(patch)
        if self.incremental:
            self._pack.append(patch)
            self.canvases = self._pack.canvases
        elif packed is not None:
            self.canvases = packed
        else:
            self.canvases = stitch(self.queue, self.m, self.n)
        self._t_ddl = min(self._t_ddl, patch.deadline)
        self.t_remain = (self._t_ddl
                         - self.latency.t_slack(len(self.canvases))
                         - self.margin)

    def _clear(self):
        self.queue = []
        self.canvases = []
        self.t_remain = math.inf
        self._pack = PackState(self.m, self.n)
        self._t_ddl = math.inf

    def _fire(self, t_now: float, reason: str) -> Invocation:
        inv = Invocation(t_now, self.canvases, self.queue,
                         self.latency.t_slack(len(self.canvases)), reason)
        self._clear()
        return inv
