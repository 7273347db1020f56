"""Completion-driven adaptive batching: AIMD over the invoker pool.

Port of ``repro/core/adaptive.py`` (plain Python).

The offline latency table tells the invoker how long *inference* takes;
it cannot see what the platform adds on top — queueing behind busy
instances, cold starts, stragglers.  Under a sustained load step the
static configuration therefore keeps firing batches whose ``t_remain``
was computed against an optimistic world, and the tight SLO classes eat
the violations.

:class:`AdaptiveInvokerPool` closes the loop the way OCTOPINF-style
workload-aware servers do: every delivered completion (the engine calls
``on_result`` at *completion-delivery* time, so the signal is what
actually happened) updates two per-class knobs on the live invoker:

* ``max_canvases`` — classic AIMD.  A violation multiplies the class's
  canvas budget by ``decrease`` (smaller batches start sooner and run
  shorter); ``patience`` consecutive clean completions add ``increase``
  back, up to the configured ceiling, recovering consolidation once the
  platform catches up.
* ``margin`` — extra firing slack subtracted from ``t_remain``.  On a
  violation it jumps to the observed excess (actual completion latency
  minus the table's conservative estimate, or the deadline miss if
  larger): the class now fires early enough to absorb the queueing delay
  completions are reporting.  Sustained clean completions decay it
  geometrically so light load drifts back to the paper's Eqn. 8.

Per-class canvas geometry flows through the same factory the static pool
uses: :class:`ClassSpec` + :func:`pool_from_specs` give each SLO class
its own canvas size, latency table, and starting budget, with or without
the AIMD controller on top.

With an :class:`~repro_torch.core.latency.OnlineLatencyTable` as a
class's latency source the two feedback loops compose instead of counting
one delay twice: drift folds into the table, and the violation excess is
measured against the class's *current* estimate, not the snapshot taken
when the invocation fired.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

from repro_torch.core.engine import InvokerPool, slo_class
from repro_torch.core.invoker import Invocation, SLOAwareInvoker
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import unknown_name


@dataclasses.dataclass(frozen=True)
class AIMDConfig:
    """Knobs for the completion-feedback controller."""
    min_canvases: int = 1         # multiplicative-decrease floor
    max_canvases: Optional[int] = None   # additive-increase ceiling; None
                                  # caps at the class invoker's configured
                                  # static budget (the operator's memory
                                  # bound is never silently exceeded)
    increase: int = 1             # canvases added per clean streak
    decrease: float = 0.5         # budget multiplier on violation
    patience: int = 3             # clean completions per increase step
    margin_decay: float = 0.75    # margin multiplier per increase step
    margin_headroom: float = 1.5  # safety factor on the observed excess
                                  # (>1: firing exactly one excess earlier
                                  # lands finishes right on the deadline)


@dataclasses.dataclass
class ClassState:
    """Controller state for one SLO class."""
    max_canvases: int
    ceiling: int = 0
    margin: float = 0.0
    streak: int = 0
    completions: int = 0
    violations: int = 0


class AdaptiveInvokerPool(InvokerPool):
    """An :class:`~repro_torch.core.engine.InvokerPool` whose per-class
    ``max_canvases`` / firing margin track delivered completions."""

    def __init__(self, make_invoker: Callable[[object], SLOAwareInvoker],
                 classify: Callable[[Patch], object] = slo_class,
                 cfg: Optional[AIMDConfig] = None,
                 model_of: Optional[Callable[[object],
                                             Optional[str]]] = None):
        super().__init__(make_invoker, classify, model_of=model_of)
        self.cfg = cfg or AIMDConfig()
        self.state: Dict[object, ClassState] = {}

    def _invoker(self, key: object) -> SLOAwareInvoker:
        inv = super()._invoker(key)
        if key not in self.state:
            ceiling = (self.cfg.max_canvases
                       if self.cfg.max_canvases is not None
                       else inv.max_canvases)
            self.state[key] = ClassState(max_canvases=inv.max_canvases,
                                         ceiling=ceiling, margin=inv.margin)
        return inv

    def on_result(self, inv: Invocation, t_finish: float):
        """Engine callback at completion delivery (not dispatch)."""
        invoker = self.invokers.get(inv.key)
        st = self.state.get(inv.key)
        if invoker is None or st is None or not inv.patches:
            return
        cfg = self.cfg
        st.completions += 1
        deadline = min(p.deadline for p in inv.patches)
        # what the platform added beyond the conservative inference
        # estimate — measured against the *current* estimate, not the
        # snapshot the invocation was scheduled with: with an
        # OnlineLatencyTable as the class's latency source, service-time
        # drift migrates into the table and the margin keeps absorbing
        # only what the estimator still cannot see (queueing, cold
        # starts), instead of double-counting the same delay
        est = max(inv.t_slack,
                  invoker.latency.t_slack(len(inv.canvases)
                                          or len(inv.patches)))
        excess = max(0.0, (t_finish - inv.t_submit) - est)
        if t_finish > deadline:
            st.violations += 1
            st.streak = 0
            st.max_canvases = max(cfg.min_canvases,
                                  int(st.max_canvases * cfg.decrease))
            miss = t_finish - deadline
            st.margin = max(st.margin,
                            cfg.margin_headroom * max(excess, miss))
        else:
            st.streak += 1
            if st.streak >= cfg.patience:
                st.streak = 0
                st.max_canvases = min(st.ceiling,
                                      st.max_canvases + cfg.increase)
                st.margin *= cfg.margin_decay
        invoker.max_canvases = st.max_canvases
        invoker.margin = st.margin


# -------------------------------------------------- per-class geometry ----

@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One SLO class's invoker recipe (geometry, latency, budget)."""
    canvas_m: int
    canvas_n: int
    latency: LatencyTable
    max_canvases: int = 8
    incremental: bool = True

    def build(self) -> SLOAwareInvoker:
        return SLOAwareInvoker(self.canvas_m, self.canvas_n, self.latency,
                               self.max_canvases,
                               incremental=self.incremental)


def pool_from_specs(specs: Mapping[object, ClassSpec],
                    default: Optional[ClassSpec] = None,
                    classify: Callable[[Patch], object] = slo_class,
                    adaptive: Optional[AIMDConfig] = None,
                    model_of: Optional[Callable[[object],
                                                Optional[str]]] = None
                    ) -> InvokerPool:
    """Pool with per-class canvas geometry, optionally AIMD-controlled.

    ``specs[key]`` builds class ``key``'s invoker; unknown keys fall back
    to ``default`` (the unified unknown-name ``ValueError`` surfaces a
    missing class early when no default is given).  Pass an
    :class:`AIMDConfig` to put the completion-feedback controller on top
    of every class; ``model_of`` tags fired invocations with their
    class's registry model (see
    :class:`~repro_torch.core.engine.InvokerPool`).
    """
    def make(key):
        spec = specs.get(key, default)
        if spec is None:
            raise unknown_name("SLO class", key, specs)
        return spec.build()

    if adaptive is not None:
        return AdaptiveInvokerPool(make, classify, adaptive,
                                   model_of=model_of)
    return InvokerPool(make, classify, model_of=model_of)


def adaptive_uniform_pool(canvas_m: int, canvas_n: int,
                          latency: LatencyTable, max_canvases: int = 8,
                          incremental: bool = True,
                          classify: Optional[Callable[[Patch], object]] = None,
                          cfg: Optional[AIMDConfig] = None,
                          model_of: Optional[Callable[[object],
                                                      Optional[str]]] = None
                          ) -> AdaptiveInvokerPool:
    """AIMD counterpart of :func:`repro_torch.core.engine.uniform_pool`: one
    shared geometry spec, per-class budgets/margins adapted online."""
    return AdaptiveInvokerPool(
        lambda key: SLOAwareInvoker(canvas_m, canvas_n, latency,
                                    max_canvases, incremental=incremental),
        classify=classify or (lambda p: None), cfg=cfg, model_of=model_of)
