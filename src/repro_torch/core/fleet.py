"""Fleet-scale sharded serving: camera-group shards under a two-level
scheduler, an event-heap invoker pool, and a cost-model planner.

Port of ``repro/core/fleet.py``.  One
:class:`~repro_torch.core.engine.ServingEngine` is one Python event loop,
so a fleet of thousands of cameras saturates the scheduler before the
card.  This module shards the engine:

* :class:`ShardedEngine` routes each camera's arrivals to its shard, a
  private :class:`~repro_torch.core.engine.ServingEngine` with its own
  invoker pool, executor and arrival bookkeeping, and merges the shards'
  outcomes in a pinned order.  On one card each shard's device executor
  runs on a CUDA stream of its own (``DeviceExecutor(stream=)``).
* :class:`FleetInvokerPool` is an
  :class:`~repro_torch.core.engine.InvokerPool` with a lazy timer heap
  keyed ``(timer, registration index)``: "no timer due" is O(1), and the
  decisions equal the stock pool's (earliest timer, then the
  first-registered class).
* :class:`FleetPlanner` and :class:`FleetCostModel` pick the camera ->
  shard grouping (LPT balancing), the per-shard worker allocation and the
  per-class reservations from per-camera rates and the profiled
  :class:`~repro_torch.core.latency.LatencyTable`;
  :meth:`FleetPlanner.replan` folds an online table's drift in.

:class:`FleetPlan` round-trips through JSON (``to_dict`` / ``from_dict``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, \
    Sequence, Tuple

from repro_torch.core.engine import InvokerPool, PatchOutcome, \
    ServingEngine, slo_class
from repro_torch.core.invoker import Invocation, SLOAwareInvoker
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import lookup
from repro_torch.core.workers import ReservedClassPlacement
from repro_torch.data.video import Arrival

__all__ = [
    "FleetCostModel", "FleetInvokerPool", "FleetPlan", "FleetPlanner",
    "EqualSplitPlanner", "ReservedClassPlacement", "ShardedEngine",
    "fleet_uniform_pool", "make_planner",
]


# ------------------------------------------------------ event-heap pool ----

class FleetInvokerPool(InvokerPool):
    """Invoker pool with an event-heap timer index (shard hot path).

    The stock pool's ``next_timer`` and ``poll`` scan every class on
    every engine event — O(classes) per *arrival*, which at fleet scale
    (hundreds of camera-group classes) dominates the event loop.  Here
    each class keeps at most one live entry ``(timer, registration
    index, version, key)`` on a heap, re-pushed whenever the class
    mutates (arrival, fire, flush — the only points an invoker's stored
    ``t_remain`` can change); stale versions are discarded lazily on
    peek.  ``poll`` therefore answers "no timer due" in O(1) and fires
    in O(log classes).

    Ordering is identical to the stock scan — earliest timer first,
    ties to the first-registered class (the heap's registration-index
    component reproduces the dict-iteration-order ``min``) — pinned by
    a randomized equivalence test against :class:`InvokerPool`.
    """

    def __init__(self, make_invoker: Callable[[object], SLOAwareInvoker],
                 classify: Callable[[Patch], object] = slo_class,
                 model_of: Optional[Callable[[object],
                                             Optional[str]]] = None):
        super().__init__(make_invoker, classify, model_of=model_of)
        self._heap: List[Tuple[float, int, int, object]] = []
        self._version: Dict[object, int] = {}
        self._reg: Dict[object, int] = {}
        self._in_heap: Dict[object, bool] = {}
        self._stale = 0

    def _invoker(self, key: object) -> SLOAwareInvoker:
        inv = self.invokers.get(key)
        if inv is None:
            inv = super()._invoker(key)
            self._reg[key] = len(self._reg)
            self._version[key] = 0
        return inv

    def _reindex(self, key: object) -> None:
        """Refresh ``key``'s heap entry after a mutation."""
        if self._in_heap.get(key):
            self._stale += 1        # the old live entry just went stale
        version = self._version[key] + 1
        self._version[key] = version
        t = self.invokers[key].next_timer()
        if t != math.inf:
            heapq.heappush(self._heap, (t, self._reg[key], version, key))
            self._in_heap[key] = True
        else:
            self._in_heap[key] = False
        if self._stale > 2 * len(self.invokers) + 16:
            # compact: the exact stale count says dead entries exceed
            # 2x the live classes, so rebuild — a churn-heavy class set
            # (cameras cycling between timered and idle) would otherwise
            # grow the heap without bound between pops
            self._heap = [e for e in self._heap
                          if self._version.get(e[3]) == e[2]]
            heapq.heapify(self._heap)
            self._stale = 0

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        key = self.classify(patch)
        fired = self._invoker(key).on_patch(t_now, patch)
        self._reindex(key)
        return self._tag(fired, key)

    def next_timer(self) -> float:
        heap = self._heap
        while heap:
            t, _, version, key = heap[0]
            if self._version.get(key) == version:
                return t
            heapq.heappop(heap)
            self._stale -= 1
        return math.inf

    def poll(self, t_now: float) -> Optional[Invocation]:
        heap = self._heap
        while heap:
            t, _, version, key = heap[0]
            if self._version.get(key) != version:
                heapq.heappop(heap)
                self._stale -= 1
                continue
            if t > t_now:
                return None
            heapq.heappop(heap)
            self._in_heap[key] = False
            fired = self.invokers[key].poll(t_now)
            self._reindex(key)
            if fired is not None:
                self._tag([fired], key)
            return fired
        return None

    def flush(self, t_now: float) -> Optional[Invocation]:
        for key, inv in self.invokers.items():
            fired = inv.flush(t_now)
            if fired is not None:
                self._reindex(key)
                self._tag([fired], key)
                return fired
        return None


def fleet_uniform_pool(canvas_m: int, canvas_n: int, latency,
                       max_canvases: int = 8, incremental: bool = True,
                       classify: Optional[Callable[[Patch], object]] = None,
                       model_of: Optional[Callable[[object],
                                                   Optional[str]]] = None
                       ) -> FleetInvokerPool:
    """:func:`~repro_torch.core.engine.uniform_pool` with the event-heap pool
    (one geometry/latency spec shared by every class)."""
    return FleetInvokerPool(
        lambda key: SLOAwareInvoker(canvas_m, canvas_n, latency,
                                    max_canvases, incremental=incremental),
        classify if classify is not None else (lambda p: None),
        model_of=model_of)


# -------------------------------------------------------------- the plan ----

@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A fleet layout: camera groups, worker allocation, reservations.

    ``camera_groups[s]`` lists the camera ids routed to shard ``s``; a
    camera id in no group (or an empty ``camera_groups``) falls back to
    ``camera_id % n_shards``, so live fleets that grow new cameras keep
    routing deterministically.  ``workers[s]`` is shard ``s``'s worker
    allocation and ``reservations[s]`` maps a class key's ``str()`` to
    the number of that shard's workers reserved for it (lowest indices
    first; empty: no reservation).  JSON-safe via ``to_dict`` /
    ``from_dict``; ``predicted`` carries the planner's per-shard
    diagnostics (rate, scheduler/device utilization, score).
    """

    n_shards: int
    camera_groups: Tuple[Tuple[int, ...], ...] = ()
    workers: Tuple[int, ...] = ()
    reservations: Tuple[Dict[str, int], ...] = ()
    predicted: Optional[dict] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.camera_groups and len(self.camera_groups) != self.n_shards:
            raise ValueError(
                f"{len(self.camera_groups)} camera groups for "
                f"{self.n_shards} shards")
        if self.workers and len(self.workers) != self.n_shards:
            raise ValueError(f"{len(self.workers)} worker allocations for "
                             f"{self.n_shards} shards")
        object.__setattr__(self, "_shard_by_camera", {
            cam: s for s, group in enumerate(self.camera_groups)
            for cam in group})

    def shard_of(self, camera_id: int) -> int:
        """Camera id -> shard index (modulo fallback for new cameras)."""
        s = self._shard_by_camera.get(camera_id)
        if s is not None:
            return s
        return camera_id % self.n_shards

    def workers_of(self, shard: int) -> int:
        return self.workers[shard] if self.workers else 1

    def to_dict(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "camera_groups": [list(g) for g in self.camera_groups],
            "workers": list(self.workers),
            "reservations": [dict(r) for r in self.reservations],
            "predicted": self.predicted,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FleetPlan":
        return cls(
            n_shards=d["n_shards"],
            camera_groups=tuple(tuple(g)
                                for g in d.get("camera_groups") or ()),
            workers=tuple(d.get("workers") or ()),
            reservations=tuple(dict(r)
                               for r in d.get("reservations") or ()),
            predicted=d.get("predicted"))


# ------------------------------------------------------------ cost model ----

@dataclasses.dataclass(frozen=True)
class FleetCostModel:
    """Per-shard resource ratios, HugeCTR-style (SNIPPETS.md snippet 3).

    The exemplar scores a candidate shard matrix by its worst
    compute/bandwidth ratio; here the two resources are the shard's
    *event loop* (a serial Python scheduler: per-event cost plus a
    per-class scan term) and its *workers* (service seconds per patch
    from the profiled latency table, scaled by the online drift ratio).
    A layout's score is the bottleneck shard's utilization plus a small
    per-shard overhead so the search does not shard without bound.

    ``service_s(batch)`` reads ``latency.mu_sigma`` — the same profiled
    table the invokers batch against — so the plan and the firing policy
    agree on how fast the accelerator is.  ``drift`` multiplies service
    time (1.0 = profile holds); :meth:`FleetPlanner.replan` feeds the
    :class:`~repro_torch.core.latency.OnlineLatencyTable`'s clamped EWMA ratio
    in, closing the offline-plan / online-reality loop.
    """

    latency: object                   # LatencyTable duck (mu_sigma)
    sched_event_s: float = 8e-6      # event-loop seconds per arrival
    sched_class_s: float = 1.2e-7    # per-class scan seconds per arrival
    consolidation: float = 4.0       # patches per fired invocation
    canvases_per_batch: int = 2      # expected canvases per invocation
    target_util: float = 0.7         # keep shards below this utilization
    shard_overhead: float = 0.01     # score penalty per shard
    drift: float = 1.0               # online latency drift multiplier

    def service_per_patch(self) -> float:
        """Accelerator-seconds of service one patch costs (amortized
        over the expected consolidation)."""
        mu, _ = self.latency.mu_sigma(self.canvases_per_batch)
        return self.drift * mu / max(self.consolidation, 1e-9)

    def sched_util(self, rate: float, n_classes: int) -> float:
        """Event-loop utilization of one shard ingesting ``rate``
        arrivals/sec over ``n_classes`` invoker classes."""
        return rate * (self.sched_event_s
                       + self.sched_class_s * max(n_classes, 1))

    def device_util(self, rate: float, workers: int) -> float:
        """Worker-pool utilization of one shard: service demand over
        ``workers`` concurrent batch servers."""
        return rate * self.service_per_patch() / max(workers, 1)

    def shard_util(self, rate: float, n_classes: int,
                   workers: int) -> float:
        return max(self.sched_util(rate, n_classes),
                   self.device_util(rate, workers))

    def score(self, group_rates: Sequence[float],
              group_classes: Sequence[int],
              workers: Sequence[int]) -> float:
        """Bottleneck-shard utilization + per-shard overhead (lower is
        better); ``inf`` for an empty candidate."""
        if not group_rates:
            return math.inf
        worst = max(self.shard_util(r, c, w) for r, c, w
                    in zip(group_rates, group_classes, workers))
        return worst + self.shard_overhead * len(group_rates)


# --------------------------------------------------------------- planner ----

def _lpt_groups(camera_rates: Mapping[int, float], n_shards: int
                ) -> Tuple[List[List[int]], List[float]]:
    """Longest-processing-time camera assignment: hottest camera first
    onto the least-loaded shard.  Returns (groups, per-group rate)."""
    heap = [(0.0, s) for s in range(n_shards)]
    heapq.heapify(heap)
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    loads = [0.0] * n_shards
    for cam, rate in sorted(camera_rates.items(),
                            key=lambda kv: (-kv[1], kv[0])):
        load, s = heapq.heappop(heap)
        groups[s].append(cam)
        loads[s] = load + rate
        heapq.heappush(heap, (loads[s], s))
    for g in groups:
        g.sort()
    return groups, loads


def _proportional_workers(loads: Sequence[float], budget: int) -> List[int]:
    """Split ``budget`` workers over shards proportionally to load
    (largest remainder), every shard getting at least one."""
    n = len(loads)
    budget = max(budget, n)
    total = sum(loads) or 1.0
    raw = [load / total * budget for load in loads]
    out = [max(1, int(r)) for r in raw]
    while sum(out) > budget:   # the max(1,...) floor may overshoot
        i = max(range(n), key=lambda j: (out[j] - raw[j], out[j]))
        if out[i] <= 1:
            break
        out[i] -= 1
    remainders = sorted(range(n), key=lambda j: (raw[j] - out[j], loads[j]),
                        reverse=True)
    i = 0
    while sum(out) < budget:
        out[remainders[i % n]] += 1
        i += 1
    return out


def _reservations(class_rates: Optional[Mapping[object, float]],
                  workers: Sequence[int]) -> Tuple[Dict[str, int], ...]:
    """Per-shard per-class worker reservations: each class gets its
    rate-proportional share of the shard's workers (floor, so something
    is always left unreserved for strays); single-class fleets and
    single-worker shards reserve nothing."""
    if not class_rates or len(class_rates) < 2:
        return tuple({} for _ in workers)
    total = sum(class_rates.values()) or 1.0
    out = []
    for w in workers:
        if w < 2:
            out.append({})
            continue
        row = {}
        for key, rate in sorted(class_rates.items(),
                                key=lambda kv: str(kv[0])):
            share = int(w * rate / total)
            if share >= 1:
                row[str(key)] = share
        out.append(row)
    return tuple(out)


class FleetPlanner:
    """Search shard layouts under :class:`FleetCostModel` (the HugeCTR
    ``Planner`` idiom: enumerate candidate shard counts, assign work,
    score, keep the argmin).

    For each candidate shard count (powers of two up to ``max_shards``)
    cameras are LPT-balanced by rate, the worker budget is split
    proportionally to shard load, and the layout is scored by the cost
    model; ties prefer fewer shards.  ``class_rates`` (optional) drives
    per-class worker reservations inside each shard.
    """

    def __init__(self, cost_model: FleetCostModel,
                 worker_budget: Optional[int] = None,
                 max_shards: int = 64):
        if max_shards < 1:
            raise ValueError(f"max_shards must be >= 1, got {max_shards}")
        self.cost_model = cost_model
        self.worker_budget = worker_budget
        self.max_shards = max_shards

    def _candidates(self, n_cameras: int) -> Iterable[int]:
        s = 1
        while s <= min(self.max_shards, n_cameras):
            yield s
            s *= 2

    def plan(self, camera_rates: Mapping[int, float],
             class_rates: Optional[Mapping[object, float]] = None,
             classes_per_camera: int = 1,
             n_shards: Optional[int] = None,
             camera_block: int = 1) -> FleetPlan:
        """Pick the layout for a fleet of ``camera_rates`` (camera id ->
        patch arrivals/sec).  ``n_shards`` pins the shard count (the
        benchmark's per-shard-count sweep); ``None`` searches.
        ``classes_per_camera`` sizes each shard's class count for the
        scheduler term (e.g. 2 when classify is (slo, group)).
        ``camera_block`` LPT-balances contiguous id-blocks of that size
        instead of single cameras — match it to the classify grouping
        (e.g. 8 for ``camera_id // 8`` keys) so cameras sharing a batch
        class land on the same shard and keep batching together."""
        if not camera_rates:
            raise ValueError("camera_rates must not be empty")
        if camera_block < 1:
            raise ValueError(
                f"camera_block must be >= 1, got {camera_block}")
        budget = (self.worker_budget if self.worker_budget is not None
                  else n_shards or 1)
        if camera_block > 1:
            block_rates: Dict[int, float] = {}
            block_members: Dict[int, List[int]] = {}
            for cam, rate in camera_rates.items():
                b = cam // camera_block
                block_rates[b] = block_rates.get(b, 0.0) + rate
                block_members.setdefault(b, []).append(cam)
            unit_rates: Mapping[int, float] = block_rates
        else:
            unit_rates = camera_rates
        best = None
        candidates = ([n_shards] if n_shards is not None
                      else self._candidates(len(camera_rates)))
        for s in candidates:
            s = min(s, len(unit_rates))
            groups, loads = _lpt_groups(unit_rates, s)
            if camera_block > 1:
                groups = [sorted(cam for b in g for cam in block_members[b])
                          for g in groups]
            workers = _proportional_workers(loads, max(budget, s))
            n_classes = [max(1, -(-len(g) // camera_block))
                         * classes_per_camera for g in groups]
            score = self.cost_model.score(loads, n_classes, workers)
            if best is None or score < best[0]:
                best = (score, s, groups, loads, workers, n_classes)
        score, s, groups, loads, workers, n_classes = best
        cm = self.cost_model
        predicted = {
            "score": round(score, 6),
            "drift": cm.drift,
            "shards": [
                {"rate": round(r, 3), "classes": c, "workers": w,
                 "sched_util": round(cm.sched_util(r, c), 4),
                 "device_util": round(cm.device_util(r, w), 4)}
                for r, c, w in zip(loads, n_classes, workers)],
        }
        return FleetPlan(
            n_shards=s,
            camera_groups=tuple(tuple(g) for g in groups),
            workers=tuple(workers),
            reservations=_reservations(class_rates, workers),
            predicted=predicted)

    def replan(self, camera_rates: Mapping[int, float], estimator,
               **kwargs) -> FleetPlan:
        """Online refinement: fold the estimator's observed drift ratio
        (:meth:`OnlineLatencyTable.drift`) into the cost model's service
        term and re-run the search — a fleet whose accelerators run
        slower than profiled gets more workers per shard (and possibly
        a different shard count) without re-profiling."""
        drift = estimator.drift() if hasattr(estimator, "drift") else 1.0
        refined = dataclasses.replace(self.cost_model, drift=drift)
        return FleetPlanner(refined, self.worker_budget,
                            self.max_shards).plan(camera_rates, **kwargs)


class EqualSplitPlanner:
    """The naive baseline the cost planner must beat: contiguous
    equal-count camera groups in id order, workers split evenly —
    oblivious to per-camera rates."""

    def __init__(self, cost_model: Optional[FleetCostModel] = None,
                 worker_budget: Optional[int] = None,
                 max_shards: int = 64, default_shards: int = 16):
        self.cost_model = cost_model
        self.worker_budget = worker_budget
        self.max_shards = max_shards
        self.default_shards = default_shards

    def plan(self, camera_rates: Mapping[int, float],
             class_rates: Optional[Mapping[object, float]] = None,
             classes_per_camera: int = 1,
             n_shards: Optional[int] = None) -> FleetPlan:
        cams = sorted(camera_rates)
        s = min(n_shards or self.default_shards, self.max_shards,
                len(cams))
        budget = max(self.worker_budget if self.worker_budget is not None
                     else s, s)
        per = -(-len(cams) // s)
        groups = [cams[i * per:(i + 1) * per] for i in range(s)]
        groups = [g for g in groups if g]
        s = len(groups)
        workers = _proportional_workers([1.0] * s, budget)
        return FleetPlan(
            n_shards=s,
            camera_groups=tuple(tuple(g) for g in groups),
            workers=tuple(workers),
            reservations=tuple({} for _ in range(s)))


_PLANNERS = {
    "cost": FleetPlanner,
    "equal": EqualSplitPlanner,
}


def make_planner(name: str, **cfg):
    """Planner-name -> instance (``cost`` | ``equal``), mirroring
    ``make_placement`` / ``make_source`` — the named reference behind
    ``ServeConfig.planner``."""
    return lookup("planner", _PLANNERS, name)(**cfg)


# --------------------------------------------------------- sharded engine ----

class ShardedEngine:
    """Camera-group shards under a two-level scheduler.

    Level 1 (global): every arrival routes to its camera's shard
    (``plan.shard_of``), with consecutive same-shard runs drained into
    the shard in one :meth:`ServingEngine.offer_batch` call; the
    completion harvest re-merges every shard's outcomes into one stream
    with a pinned order.  Level 2 (group-local): each shard is a private
    :class:`~repro_torch.core.engine.ServingEngine` — its own invoker pool
    (classes = the shard's camera groups x SLO), executor / worker
    subset, arrival slots, and event heap — so batching and timer firing
    never contend with other shards' cameras.

    With one shard this is *event-identical* to driving the inner
    ``ServingEngine`` directly (pinned by test): routing degenerates to
    the identity and the merge to a copy.

    Cross-shard outcome order is pinned: ``(t_finish, shard index,
    within-shard delivery order)`` — simultaneous completions on
    different shards deliver in shard order, so N-shard replays are
    reproducible run-to-run (regression-tested).
    """

    def __init__(self, shards: Sequence[ServingEngine],
                 shard_of_camera: Callable[[int], int],
                 plan: Optional[FleetPlan] = None):
        if not shards:
            raise ValueError("ShardedEngine needs at least one shard")
        self.shards = list(shards)
        self.shard_of_camera = shard_of_camera
        self.plan = plan
        self.ingestion_window = None
        for eng in self.shards:
            if eng.ingestion_window is not None:
                self.ingestion_window = ((self.ingestion_window or 0)
                                         + eng.ingestion_window)
        self._outcomes: Optional[List[PatchOutcome]] = None
        self._finished = False

    @classmethod
    def build(cls, plan: FleetPlan,
              make_shard: Callable[[int, FleetPlan], ServingEngine]
              ) -> "ShardedEngine":
        """Construct the fleet from a plan: ``make_shard(s, plan)``
        builds shard ``s``'s engine (pool + executor wired to
        ``plan.workers_of(s)`` / ``plan.reservations[s]``)."""
        shards = [make_shard(s, plan) for s in range(plan.n_shards)]
        return cls(shards, plan.shard_of, plan=plan)

    # ----------------------------------------------------------- feeding ----

    def shard_of(self, patch: Patch) -> int:
        return self.shard_of_camera(patch.camera_id)

    def offer(self, arrival: Arrival):
        self._outcomes = None
        self.shards[self.shard_of(arrival.patch)].offer(arrival)

    def run(self, arrivals: Sequence[Arrival]) -> List[PatchOutcome]:
        """Drive a merged (sorted-by-``t_arrive``) fleet trace to empty.

        Consecutive same-shard arrivals are drained into the shard in
        one ``offer_batch`` call, so the global router touches each
        *run*, not each event."""
        shard_of_camera = self.shard_of_camera
        run_buf: List[Arrival] = []
        current = -1
        for arr in arrivals:
            s = shard_of_camera(arr.patch.camera_id)
            if s != current:
                if run_buf:
                    self.shards[current].offer_batch(run_buf)
                    run_buf = []
                current = s
            run_buf.append(arr)
        if run_buf:
            self.shards[current].offer_batch(run_buf)
        self.finish()
        return self.outcomes

    def serve(self, source) -> List[PatchOutcome]:
        """Pull loop over a :mod:`repro_torch.sources` source; this engine is
        the backpressure handle (global backlog vs the summed window)."""
        for arr in source.events(self):
            self.offer(arr)
        self.finish()
        return self.outcomes

    def finish(self, t_end: Optional[float] = None):
        # Barrier-clock members (parallel-runtime equivalence tests):
        # lift every shard to the fleet-wide max time before finishing,
        # the non-blocking twin of the threaded runners' end-of-input
        # ``sync()`` — so both paths flush trailing partial canvases at
        # the same engine time.
        aligned = []
        for eng in self.shards:
            parent = getattr(eng.clock, "parent", None)
            if parent is not None and hasattr(parent, "align") \
                    and all(parent is not p for p in aligned):
                parent.align()
                aligned.append(parent)
        for s, eng in enumerate(self.shards):
            eng.finish(t_end)
            for inv in eng.invocations:
                if inv.shard is None:
                    inv.shard = s
        self._finished = True
        self._outcomes = None

    # ------------------------------------------------------- backpressure ----

    def backlog(self) -> int:
        return sum(eng.backlog() for eng in self.shards)

    def queued_patches(self) -> int:
        return sum(eng.queued_patches() for eng in self.shards)

    def inflight_patches(self) -> int:
        return sum(eng.inflight_patches() for eng in self.shards)

    def overloaded(self) -> bool:
        return (self.ingestion_window is not None
                and self.backlog() >= self.ingestion_window)

    @property
    def backlog_high_water(self) -> int:
        """Upper bound on the global backlog peak (shard peaks need not
        coincide; the exact global maximum would cost O(shards) per
        arrival to track)."""
        return sum(eng.backlog_high_water for eng in self.shards)

    @property
    def arrivals_total(self) -> int:
        return sum(eng.arrivals_total for eng in self.shards)

    # ----------------------------------------------------------- harvest ----

    @property
    def outcomes(self) -> List[PatchOutcome]:
        """Every shard's outcomes merged into one stream, ordered by
        ``(t_finish, shard index, within-shard delivery order)`` — the
        pinned cross-shard tie rule."""
        if self._outcomes is None:
            rows = []
            for s, eng in enumerate(self.shards):
                rows.extend(((o.t_finish, s, i), o)
                            for i, o in enumerate(eng.outcomes))
            rows.sort(key=lambda r: r[0])
            self._outcomes = [o for _, o in rows]
        return self._outcomes

    @property
    def invocations(self) -> List[Invocation]:
        return [inv for eng in self.shards for inv in eng.invocations]

    @property
    def completions(self) -> List:
        return [c for eng in self.shards for c in eng.completions]

    def shard_stats(self, horizon: Optional[float] = None) -> List[dict]:
        """Per-shard observability rows (``Results.summary()``'s
        ``per_shard`` section): arrivals, invocations, violations,
        backlog high water, and utilization — shard imbalance without a
        profiler."""
        if horizon is None:
            horizon = max((o.t_finish for o in self.outcomes), default=0.0)
        rows = []
        for s, eng in enumerate(self.shards):
            violations = sum(o.violated for o in eng.outcomes)
            row = {
                "shard": s,
                "cameras": (len(self.plan.camera_groups[s])
                            if self.plan and self.plan.camera_groups
                            else None),
                "workers": (self.plan.workers_of(s) if self.plan else 1),
                "arrivals": eng.arrivals_total,
                "invocations": len(eng.invocations),
                "violations": violations,
                "violation_rate": round(
                    violations / max(len(eng.outcomes), 1), 4),
                "backlog_high_water": eng.backlog_high_water,
            }
            platform = getattr(eng.executor, "platform", None)
            if platform is not None and horizon > 0:
                row["utilization"] = round(platform.utilization(horizon), 4)
            rows.append(row)
        return rows
