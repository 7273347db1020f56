"""Multi-worker executor pool: route concurrent invocations across workers.

Port of ``repro/core/workers.py``.  :class:`WorkerPoolExecutor` puts N
independent executors behind the engine's executor protocol (``submit`` /
``resolve`` / ``ready`` / ``max_inflight`` / ``on_complete``) and sends
each fired :class:`~repro_torch.core.invoker.Invocation` to the worker a
**placement policy** picks:

* :class:`LeastOutstandingPlacement` (default): the worker with the fewest
  unresolved invocations, lowest index on ties;
* :class:`RoundRobinPlacement`;
* :class:`ClassAffinityPlacement`: tight-SLO classes get reserved
  workers, everything else spreads over the rest;
* :class:`ModelAffinityPlacement`: batches of one model co-locate so its
  weights stay resident (see :class:`WeightCache`, a per-worker LRU with
  a modeled load cost);
* :class:`ReservedClassPlacement`: per-class worker counts.

Workers are plain executors: ``SimExecutor``\\ s over platform shards
(:func:`repro_torch.serverless.platform.split_platform`) or device
executors (:func:`device_worker_pool`).  Worker ``i`` runs on its serve
mesh of ``launch/mesh.make_worker_meshes`` (a contiguous slice of the
devices; with fewer devices than workers, device ``i % n_devices``), as
the reference lays its workers out.  On a one-card host every worker
shares the card and its current stream, the counterpart of the JAX pool
on a one-device host: the pool then routes, accounts and feeds the
estimator per worker, but the card runs one invocation at a time.

With an :class:`~repro_torch.core.latency.OnlineLatencyTable` (or a
:class:`~repro_torch.core.latency.LatencyBank`) as ``estimator``, every
resolved completion feeds its submit-to-finish time back into the table
the invokers fire against.  :func:`share_frame_store` aliases one
refcounted frame store across a pool's device executors, so any worker
can gather crops of any frame and a frame is evicted when its last patch
is routed, whichever worker routed it.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.engine import Completion, ExecHandle
from repro_torch.core.invoker import Invocation
from repro_torch.core.registry import lookup


# ----------------------------------------------------- weight cache ----

class WeightCache:
    """Per-worker model-weight residency: LRU over a byte budget.

    ``models`` maps a registry model name to ``(weight_bytes, load_s)``
    (both off a :class:`~repro_torch.core.models.ModelSpec`).
    :meth:`ensure` is the one mutation: it returns the load seconds to add
    to the invocation's finish time (0.0 on a hit), marks the model most
    recently used, and evicts least recently used residents until the new
    weights fit.  A model larger than the whole budget still loads, alone.
    Unknown or untagged models cost nothing and are not cached.  Eviction
    order depends on the access sequence alone.
    """

    def __init__(self, capacity_bytes: float,
                 models: Mapping[str, Tuple[float, float]]):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity_bytes = float(capacity_bytes)
        self.models = {name: (float(size), float(load))
                       for name, (size, load) in models.items()}
        self._resident: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()          # name -> weight_bytes
        self.used_bytes = 0.0
        self.hits: Dict[str, int] = {}
        self.misses: Dict[str, int] = {}
        self.evictions = 0
        self.load_seconds = 0.0

    def holds(self, model: Optional[str]) -> bool:
        return model in self._resident

    def resident(self) -> List[str]:
        """Resident model names, least recently used first."""
        return list(self._resident)

    @property
    def n_hits(self) -> int:
        return sum(self.hits.values())

    @property
    def n_misses(self) -> int:
        return sum(self.misses.values())

    @property
    def hit_rate(self) -> float:
        total = self.n_hits + self.n_misses
        return self.n_hits / total if total else 0.0

    def ensure(self, model: Optional[str]) -> float:
        """Make ``model`` resident; returns the modeled load seconds."""
        if model is None or model not in self.models:
            return 0.0
        if model in self._resident:
            self._resident.move_to_end(model)
            self.hits[model] = self.hits.get(model, 0) + 1
            return 0.0
        size, load_s = self.models[model]
        while self._resident and self.used_bytes + size > self.capacity_bytes:
            _, evicted = self._resident.popitem(last=False)
            self.used_bytes -= evicted
            self.evictions += 1
        self._resident[model] = size
        self.used_bytes += size
        self.misses[model] = self.misses.get(model, 0) + 1
        self.load_seconds += load_s
        return load_s

    def stats(self) -> dict:
        return {"hits": self.n_hits, "misses": self.n_misses,
                "hit_rate": round(self.hit_rate, 4),
                "evictions": self.evictions,
                "load_s": round(self.load_seconds, 4),
                "resident": self.resident()}


def weight_caches(n_workers: int, capacity_bytes: float,
                  models: Mapping[str, Tuple[float, float]]
                  ) -> List[WeightCache]:
    """One independent :class:`WeightCache` per pool worker."""
    return [WeightCache(capacity_bytes, models) for _ in range(n_workers)]


# ------------------------------------------------------- placement ----

def _least(pool: "WorkerPoolExecutor", allowed) -> int:
    return min(allowed, key=lambda i: (pool.outstanding[i], i))


class LeastOutstandingPlacement:
    """The worker with the fewest unresolved invocations (lowest index on
    ties): join the shortest queue."""

    def choose(self, inv: Invocation, pool: "WorkerPoolExecutor") -> int:
        return _least(pool, range(pool.n_workers))


class RoundRobinPlacement:
    """Cycle through the workers regardless of load."""

    def __init__(self):
        self._next = 0

    def choose(self, inv: Invocation, pool: "WorkerPoolExecutor") -> int:
        idx = self._next % pool.n_workers
        self._next += 1
        return idx


class ClassAffinityPlacement:
    """Reserve workers for specific SLO classes.

    ``reserved`` maps a class key (``inv.key``) to the worker indices its
    batches may run on; other keys spread over the unreserved workers (or
    every worker when none is left), least outstanding within the allowed
    set.  ``reserve_tightest=k`` reserves the first ``k`` workers for the
    smallest class key seen so far, once a second class has been seen
    (with one class there is nothing to protect it from).
    """

    def __init__(self, reserved: Optional[Mapping[object,
                                                  Sequence[int]]] = None,
                 reserve_tightest: int = 0):
        self.reserved = {k: tuple(v) for k, v in (reserved or {}).items()}
        self.reserve_tightest = reserve_tightest
        self._tightest: object = None
        self._seen: set = set()

    def _allowed(self, key: object, n_workers: int) -> Sequence[int]:
        if self.reserve_tightest > 0:
            k = min(self.reserve_tightest, n_workers)
            self._seen.add(key)
            try:
                if self._tightest is None or key < self._tightest:
                    self._tightest = key
            except TypeError:          # keys that do not compare: the first
                if self._tightest is None:
                    self._tightest = key
            if len(self._seen) < 2:
                return range(n_workers)
            if key == self._tightest:
                return range(k)
            rest = range(k, n_workers)
            return rest if len(rest) else range(n_workers)
        if key in self.reserved:
            allowed = [i for i in self.reserved[key] if i < n_workers]
            if allowed:
                return allowed
        taken = {i for v in self.reserved.values() for i in v}
        free = [i for i in range(n_workers) if i not in taken]
        return free if free else range(n_workers)

    def choose(self, inv: Invocation, pool: "WorkerPoolExecutor") -> int:
        return _least(pool, self._allowed(inv.key, pool.n_workers))


class ReservedClassPlacement:
    """Per-class worker reservations by count.

    ``reserved`` maps a class key's ``str()`` to a worker count: that
    class's batches run on the lowest-index workers reserved for it (in
    sorted key order), unmatched classes on the rest (everything when
    nothing is left); least outstanding within the allowed set.
    """

    def __init__(self, reserved: Mapping[str, int]):
        self.reserved = dict(reserved)
        self._ranges: Dict[str, range] = {}
        start = 0
        for key in sorted(self.reserved):
            count = self.reserved[key]
            self._ranges[key] = range(start, start + count)
            start += count
        self._first_free = start

    def choose(self, inv: Invocation, pool: "WorkerPoolExecutor") -> int:
        allowed = self._ranges.get(str(inv.key))
        if allowed is None or len(allowed) == 0:
            allowed = range(self._first_free, pool.n_workers)
            if len(allowed) == 0:
                allowed = range(pool.n_workers)
        allowed = [i for i in allowed if i < pool.n_workers]
        if not allowed:
            allowed = list(range(pool.n_workers))
        return _least(pool, allowed)


class ModelAffinityPlacement:
    """Co-locate batches of one model so its weights stay resident.

    A model-tagged invocation (``inv.model``) goes to the least
    outstanding worker whose :class:`WeightCache` holds the model; without
    one, to the model's sticky home worker (assigned round robin on first
    sight).  Untagged invocations go to the least outstanding worker.  The
    pool's per-worker in-flight bound still wins over affinity.
    """

    def __init__(self):
        self._home: Dict[str, int] = {}
        self._next = 0

    def choose(self, inv: Invocation, pool: "WorkerPoolExecutor") -> int:
        model = getattr(inv, "model", None)
        if model is None:
            return _least(pool, range(pool.n_workers))
        caches = pool.weight_caches
        if caches is not None:
            resident = [i for i in range(pool.n_workers)
                        if caches[i].holds(model)]
            if resident:
                return _least(pool, resident)
        home = self._home.get(model)
        if home is None:
            home = self._home[model] = self._next % pool.n_workers
            self._next += 1
        return home


_PLACEMENTS = {
    "least": LeastOutstandingPlacement,
    "round": RoundRobinPlacement,
    "affinity": lambda: ClassAffinityPlacement(reserve_tightest=1),
    "model": ModelAffinityPlacement,
}


def make_placement(name: str):
    """Placement-name -> policy instance
    (``least`` | ``round`` | ``affinity`` | ``model``)."""
    return lookup("placement", _PLACEMENTS, name)()


# ------------------------------------------------------------ pool ----

class WorkerPoolExecutor:
    """N independent workers behind one engine-facing executor.

    ``placement`` chooses a worker per invocation; ``estimator`` receives
    every resolved completion's ``(batch, elapsed, worker[, model])``.
    ``max_inflight`` is the sum of the workers' bounds.  A worker's own
    bound is hard (each unresolved handle pins device memory on it), so an
    invocation placed on a full worker goes to the least outstanding
    worker with room.  Workers without a bound (sim workers) are never
    full; a pool of only those exposes no bound.  With ``weight_caches``
    a placed batch pays its model's load: at submit when the worker knows
    the finish time, else at resolve.
    """

    def __init__(self, workers: Sequence[object], placement=None,
                 estimator=None,
                 weight_caches: Optional[Sequence[WeightCache]] = None):
        if not workers:
            raise ValueError("WorkerPoolExecutor needs at least one worker")
        self.workers = list(workers)
        self.placement = placement or LeastOutstandingPlacement()
        self.estimator = estimator
        if weight_caches is not None and len(weight_caches) != len(workers):
            raise ValueError(
                f"weight_caches has {len(weight_caches)} entries "
                f"for {len(workers)} workers")
        self.weight_caches = (list(weight_caches)
                              if weight_caches is not None else None)
        n = len(self.workers)
        self.outstanding = [0] * n       # unresolved invocations per worker
        self.n_submitted = [0] * n
        self.n_patches = [0] * n
        self.busy_s = [0.0] * n          # union of per-worker busy intervals
        self._last_finish = [0.0] * n
        bounds = [getattr(w, "max_inflight", None) for w in self.workers]
        known = [b for b in bounds if b is not None]
        if known:
            self.max_inflight = sum(known)

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    def _has_room(self, idx: int) -> bool:
        bound = getattr(self.workers[idx], "max_inflight", None)
        return bound is None or self.outstanding[idx] < bound

    # ------------------------------------------------ engine protocol ----

    def submit(self, inv: Invocation) -> ExecHandle:
        idx = self.placement.choose(inv, self)
        if not 0 <= idx < self.n_workers:
            raise ValueError(f"placement chose worker {idx} "
                             f"of {self.n_workers}")
        if not self._has_room(idx):
            room = [i for i in range(self.n_workers) if self._has_room(i)]
            if room:
                idx = _least(self, room)
        handle = self.workers[idx].submit(inv)
        handle.worker = idx
        if self.weight_caches is not None:
            # residency is decided where the batch lands, here
            load_s = self.weight_caches[idx].ensure(
                getattr(inv, "model", None))
            if load_s:
                if handle.t_finish is not None:
                    handle.t_finish += load_s
                    if handle.completion is not None:
                        handle.completion.t_finish += load_s
                else:
                    # async worker: the finish is known at resolve
                    handle.load_s += load_s
        self.outstanding[idx] += 1
        self.n_submitted[idx] += 1
        self.n_patches[idx] += len(inv.patches)
        return handle

    def ready(self, handle: ExecHandle) -> bool:
        probe = getattr(self.workers[handle.worker], "ready", None)
        if probe is None:
            return handle.completion is not None
        return probe(handle)

    def resolve(self, handle: ExecHandle) -> Completion:
        comp = self.workers[handle.worker].resolve(handle)
        w = handle.worker
        comp.worker = w
        if handle.load_s:
            comp.t_finish += handle.load_s
            handle.load_s = 0.0
        self.outstanding[w] -= 1
        elapsed = comp.t_finish - comp.invocation.t_submit
        if math.isfinite(elapsed) and elapsed > 0:
            # the union of the worker's service intervals: a queued
            # invocation starts where the previous one finished
            start = max(comp.invocation.t_submit, self._last_finish[w])
            self.busy_s[w] += max(0.0, comp.t_finish - start)
            self._last_finish[w] = max(self._last_finish[w], comp.t_finish)
        if self.estimator is not None:
            # submit -> finish, queueing on the worker included: what
            # t_slack must cover for a firing decision to be safe
            batch = (len(comp.invocation.canvases)
                     or len(comp.invocation.patches))
            model = getattr(comp.invocation, "model", None)
            if model is not None:
                self.estimator.observe(batch, elapsed, worker=w,
                                       model=model)
            else:
                self.estimator.observe(batch, elapsed, worker=w)
        return comp

    def on_complete(self, comp: Completion):
        on_complete = getattr(self.workers[comp.worker], "on_complete", None)
        if on_complete is not None:
            on_complete(comp)

    # ---------------------------------------------- frame store facade ----

    def add_frame(self, frame_id, pixels, n_patches: int):
        """Register a frame once: device workers share one store
        (:func:`share_frame_store`)."""
        self.workers[0].add_frame(frame_id, pixels, n_patches)

    @property
    def frames(self):
        return self.workers[0].frames

    # --------------------------------------------------- aggregation ----

    def _sum(self, attr: str) -> int:
        return sum(getattr(w, attr, 0) for w in self.workers)

    @property
    def n_invocations(self) -> int:
        return self._sum("n_invocations")

    @property
    def n_detections(self) -> int:
        return self._sum("n_detections")

    @property
    def n_sharded(self) -> int:
        return self._sum("n_sharded")

    @property
    def evidence_bytes(self) -> int:
        return self._sum("evidence_bytes")

    def worker_stats(self) -> List[dict]:
        """Per-worker counters for ``Results.worker_stats``."""
        stats = []
        for i in range(self.n_workers):
            ws = {"worker": i,
                  "invocations": self.n_submitted[i],
                  "patches": self.n_patches[i],
                  "busy_s": round(self.busy_s[i], 4)}
            if self.estimator is not None:
                ws["drift"] = round(self.estimator.drift(worker=i), 3)
            if self.weight_caches is not None:
                ws["weights"] = self.weight_caches[i].stats()
            stats.append(ws)
        return stats

    def model_cache_stats(self) -> Dict[str, dict]:
        """Per-model weight-cache hits and misses over every worker's
        cache (empty without caches)."""
        if self.weight_caches is None:
            return {}
        out: Dict[str, dict] = {}
        for cache in self.weight_caches:
            for name in set(cache.hits) | set(cache.misses):
                row = out.setdefault(name, {"weight_hits": 0,
                                            "weight_misses": 0})
                row["weight_hits"] += cache.hits.get(name, 0)
                row["weight_misses"] += cache.misses.get(name, 0)
        for row in out.values():
            total = row["weight_hits"] + row["weight_misses"]
            row["weight_hit_rate"] = (round(row["weight_hits"] / total, 4)
                                      if total else 0.0)
        return out


def share_frame_store(executors: Sequence[object]) -> None:
    """Alias the first executor's refcounted frame store across the rest,
    so a frame's refcount drains pool-wide: patches cut from one frame may
    be routed by different workers."""
    if executors:
        for ex in executors[1:]:
            ex.store = executors[0].store


def device_worker_pool(n_workers: int, make_executor: Callable[[int], object],
                       placement=None, estimator=None,
                       weight_caches: Optional[Sequence[WeightCache]] = None
                       ) -> WorkerPoolExecutor:
    """A device pool: ``make_executor(i)`` builds worker ``i`` (typically
    an ``AsyncDeviceExecutor`` on worker ``i``'s serve mesh); the
    frame stores are shared and the pool assembled."""
    workers = [make_executor(i) for i in range(n_workers)]
    share_frame_store(workers)
    return WorkerPoolExecutor(workers, placement=placement,
                              estimator=estimator,
                              weight_caches=weight_caches)
