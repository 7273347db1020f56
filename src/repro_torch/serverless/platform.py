"""Serverless platform model: instances, cold starts, autoscaling, billing.

Port of ``repro/serverless/platform.py`` (numpy and plain Python).  A
deterministic (seeded) discrete-event model of a GPU serverless platform
with the paper's semantics: per-function concurrency = 1, pay per
execution-second (Eqn. 1), fast scale-up with a cold-start penalty, with
straggler injection and optional backup dispatch (hedged requests).  The
jitter comes from ``numpy.random.default_rng(cfg.seed)``, drawn in the
reference's order, so one seed gives the JAX package's records.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.cost import CostMeter
from repro_torch.core.latency import LatencyTable


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    cold_start_s: float = 0.25       # container + weights to accelerator
    container_cold_s: Optional[float] = None
                                     # multi-model decomposition: the
                                     # container-only share of a cold start
                                     # (weights billed separately per model
                                     # via submit's model_load_s).  None:
                                     # cold_start_s covers the container and
                                     # the model load rides on top.
    keep_alive_s: float = 60.0
    max_instances: int = 64
    concurrency: int = 1             # paper setting
    pre_warm: int = 1                # provisioned instances (the paper's
                                     # offline profiling warms the function)
    straggler_prob: float = 0.0
    straggler_factor: float = 4.0
    backup_after_sigma: float = math.inf   # hedged dispatch threshold
    seed: int = 0

    def per_worker(self, n_workers: int, worker: int = 0) -> "PlatformConfig":
        """Capacity shard of this config for one of ``n_workers`` pool
        workers.  Total capacity is conserved exactly: instance and
        pre-warm budgets are split with the remainder going to the
        lowest-index workers, so summing the shards reproduces the
        source config and an ``n_workers`` sweep compares platforms of
        identical aggregate capacity.  Jitter seeds are offset per
        worker so shards draw independent streams.  More workers than
        instances is refused — a zero-instance shard cannot serve."""
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if not 0 <= worker < n_workers:
            raise ValueError(f"worker {worker} not in [0, {n_workers})")
        if self.max_instances < n_workers:
            raise ValueError(
                f"cannot shard {self.max_instances} instances across "
                f"{n_workers} workers (a worker needs >= 1)")

        def share(total: int) -> int:
            return total // n_workers + (1 if worker < total % n_workers
                                         else 0)

        return dataclasses.replace(
            self, max_instances=share(self.max_instances),
            pre_warm=share(self.pre_warm), seed=self.seed + worker)


@dataclasses.dataclass
class _Instance:
    free_at: float = 0.0
    warm_until: float = -1.0
    model: Optional[str] = None      # weights currently resident (None:
                                     # nothing loaded / single-model legacy)


@dataclasses.dataclass
class ExecutionRecord:
    t_submit: float
    t_start: float
    t_finish: float
    exec_s: float
    batch_size: int              # canvases in the invocation
    cold: bool
    hedged: bool
    cost: float
    n_patches: int = 0           # patches consolidated into the batch
    instance: int = -1           # index of the instance that ran it
    backup_instance: int = -1    # hedged backup's instance (-1: none)
    backup_t_start: float = 0.0
    backup_exec_s: float = 0.0
    model: Optional[str] = None  # registry model the batch ran
    load_s: float = 0.0          # weight-load seconds paid (0.0: warm hit)
    weight_loaded: bool = False  # the instance swapped weights in


class Platform:
    def __init__(self, latency: LatencyTable, cfg: PlatformConfig = PlatformConfig(),
                 meter: Optional[CostMeter] = None):
        self.latency = latency
        self.cfg = cfg
        self.meter = meter or CostMeter()
        self.instances: List[_Instance] = [
            _Instance(free_at=0.0, warm_until=cfg.keep_alive_s)
            for _ in range(cfg.pre_warm)]
        self.records: List[ExecutionRecord] = []
        self._rng = np.random.default_rng(cfg.seed)

    # ----------------------------------------------------------- sampling ----

    def _sample_exec(self, batch_size: int,
                     table: Optional[LatencyTable] = None
                     ) -> Tuple[float, bool]:
        mu, sigma = (table or self.latency).mu_sigma(batch_size)
        t = mu + abs(float(self._rng.normal())) * sigma  # one-sided jitter
        straggler = bool(self._rng.random() < self.cfg.straggler_prob)
        if straggler:
            t *= self.cfg.straggler_factor
        return t, straggler

    # ---------------------------------------------------------- placement ----

    @property
    def _container_cold_s(self) -> float:
        cc = self.cfg.container_cold_s
        return self.cfg.cold_start_s if cc is None else cc

    def _acquire(self, t: float, model: Optional[str] = None,
                 load_s: float = 0.0
                 ) -> Tuple[_Instance, float, bool, bool]:
        """Pick a warm free instance, else scale up (cold start), else
        queue on the earliest-free instance.  Returns ``(instance, start,
        cold, loaded)``.

        Among warm free instances the *most recently used* one (max
        ``warm_until``) wins: traffic concentrates on a small hot set, so
        the idle tail cools and falls out of keep-alive instead of every
        instance's lease being refreshed round-robin by stray requests.

        Multi-model economics: an instance warm for model A is *not* warm
        for model B — a warm-free instance holding the right ``model``
        beats one holding another model, which still saves the container
        cold start but pays ``load_s`` to swap weights in.  A genuine
        scale-up pays the container share (``container_cold_s``, falling
        back to ``cold_start_s``) plus ``load_s``.  With ``model=None``
        every instance matches (all start at model ``None``) and the
        behaviour is exactly the legacy single-model path.
        """
        warm_free = [i for i in self.instances
                     if i.free_at <= t and i.warm_until >= t]
        if warm_free:
            same = [i for i in warm_free if i.model == model]
            if same:
                return max(same, key=lambda i: i.warm_until), t, False, False
            # warm container, wrong weights: swap in
            inst = max(warm_free, key=lambda i: i.warm_until)
            return inst, t + load_s, False, load_s > 0
        if len(self.instances) < self.cfg.max_instances:
            inst = _Instance()
            self.instances.append(inst)
            return (inst, t + self._container_cold_s + load_s, True,
                    load_s > 0)
        inst = min(self.instances, key=lambda i: i.free_at)
        start = max(t, inst.free_at)
        cold = inst.warm_until < start
        loaded = False
        if cold:
            start += self._container_cold_s + load_s
            loaded = load_s > 0
        elif inst.model != model:
            start += load_s
            loaded = load_s > 0
        return inst, start, cold, loaded

    # ------------------------------------------------------------- submit ----

    def submit(self, t_submit: float, batch_size: int,
               n_patches: int = 0, model: Optional[str] = None,
               model_load_s: float = 0.0,
               latency: Optional[LatencyTable] = None) -> ExecutionRecord:
        """Run one batch.  ``model``/``model_load_s`` opt into per-model
        warm pools (see :meth:`_acquire`); ``latency`` overrides the
        platform table for this submission (each model samples from its
        own profile).  The defaults reproduce the single-model platform
        exactly."""
        inst, t_start, cold, loaded = self._acquire(t_submit, model=model,
                                                    load_s=model_load_s)
        table = latency or self.latency
        exec_s, straggler = self._sample_exec(batch_size, table)

        hedged = False
        mu, sigma = table.mu_sigma(batch_size)
        threshold = mu + self.cfg.backup_after_sigma * sigma
        t_finish = t_start + exec_s
        cost = self.meter.charge(exec_s)

        # commit the primary's busy interval BEFORE any hedged acquire:
        # with free_at still stale, _acquire at t_start + threshold used to
        # hand the backup the very instance the primary is running on —
        # two overlapping busy intervals billed on one concurrency-1
        # instance (double-billed warm time, utilization > 1 possible)
        inst.free_at = t_start + exec_s
        inst.warm_until = inst.free_at + self.cfg.keep_alive_s
        inst.model = model

        b_instance, b_start, backup_exec = -1, 0.0, 0.0
        if exec_s > threshold:
            # hedged backup on a second instance, fired at the threshold
            hedged = True
            backup_exec, _ = self._sample_exec(batch_size, table)
            inst2, b_start, b_cold, _ = self._acquire(
                t_start + threshold, model=model, load_s=model_load_s)
            t_finish = min(t_finish, b_start + backup_exec)
            cost += self.meter.charge(backup_exec)
            inst2.free_at = b_start + backup_exec
            inst2.warm_until = inst2.free_at + self.cfg.keep_alive_s
            inst2.model = model
            b_instance = self.instances.index(inst2)

        rec = ExecutionRecord(t_submit, t_start, t_finish, exec_s,
                              batch_size, cold, hedged, cost,
                              n_patches=n_patches,
                              instance=self.instances.index(inst),
                              backup_instance=b_instance,
                              backup_t_start=b_start,
                              backup_exec_s=backup_exec,
                              model=model,
                              load_s=model_load_s if loaded else 0.0,
                              weight_loaded=loaded)
        self.records.append(rec)
        return rec

    # ------------------------------------------------------------ metrics ----

    @property
    def total_cost(self) -> float:
        return self.meter.total

    @property
    def mean_consolidation(self) -> float:
        """Mean patches consolidated per invocation, over records that
        reported patch counts (0.0 when none did)."""
        return mean_consolidation(self.records)

    def busy_intervals(self) -> dict:
        """Per-instance busy intervals ``{idx: [(start, end), ...]}``.

        Every billed second appears in exactly one interval (primaries
        and hedged backups each on their own instance), so
        ``sum(lengths) == meter.busy_seconds`` — the audit that overlapping
        in-flight invocations are never double-billed onto one
        concurrency-1 instance."""
        out: dict = {}
        for r in self.records:
            out.setdefault(r.instance, []).append(
                (r.t_start, r.t_start + r.exec_s))
            if r.backup_instance >= 0:
                out.setdefault(r.backup_instance, []).append(
                    (r.backup_t_start, r.backup_t_start + r.backup_exec_s))
        for iv in out.values():
            iv.sort()
        return out

    def utilization(self, horizon: float) -> float:
        if not self.instances or horizon <= 0:
            return 0.0
        return self.meter.busy_seconds / (len(self.instances) * horizon)

    def model_stats(self) -> dict:
        """Per-model platform economics over this platform's records
        (empty when no record was model-tagged): invocations, patches,
        cold starts, weight loads + seconds, and the weight warm-hit
        rate ``1 - weight_loads / invocations``."""
        return model_stats(self.records)


def model_stats(records: List[ExecutionRecord]) -> dict:
    """Aggregate per-model counters from execution records (shared by
    :meth:`Platform.model_stats` and multi-shard scheduler assembly)."""
    out: dict = {}
    for r in records:
        if r.model is None:
            continue
        row = out.setdefault(r.model, {
            "invocations": 0, "patches": 0, "cold_starts": 0,
            "weight_loads": 0, "load_seconds": 0.0})
        row["invocations"] += 1
        row["patches"] += r.n_patches
        row["cold_starts"] += int(r.cold)
        row["weight_loads"] += int(r.weight_loaded)
        row["load_seconds"] += r.load_s
    for row in out.values():
        n = row["invocations"]
        row["load_seconds"] = round(row["load_seconds"], 4)
        row["weight_hit_rate"] = (round(1.0 - row["weight_loads"] / n, 4)
                                  if n else 0.0)
    return out


def mean_consolidation(records: List[ExecutionRecord]) -> float:
    """Mean patches consolidated per invocation over records that
    reported patch counts (0.0 when none did) — shared by the platform
    property and multi-shard aggregation in the scheduler."""
    counted = [r.n_patches for r in records if r.n_patches > 0]
    if not counted:
        return 0.0
    return sum(counted) / len(counted)


def split_platform(platform: Platform, n_workers: int,
                   weights: Optional[List[float]] = None) -> List[Platform]:
    """Per-worker capacity shards of one platform (the simulation twin of
    splitting the device mesh into worker slices).

    Each shard gets ``cfg.per_worker``'s instance budget and its own
    jitter stream, but all shards **share the source platform's cost
    meter** — total cost / busy seconds aggregate exactly as if one
    platform had served everything, so Results accounting is unchanged
    by the split.

    ``weights`` (optional, one per shard) splits the instance and
    pre-warm budgets *proportionally* instead of evenly — the fleet
    planner's per-shard worker allocation — still conserving the totals
    exactly (largest remainder, at least one instance per shard)."""
    if weights is None:
        return [Platform(platform.latency,
                         platform.cfg.per_worker(n_workers, worker=i),
                         meter=platform.meter)
                for i in range(n_workers)]
    if len(weights) != n_workers:
        raise ValueError(f"{len(weights)} weights for {n_workers} shards")
    cfg = platform.cfg
    if cfg.max_instances < n_workers:
        raise ValueError(
            f"cannot shard {cfg.max_instances} instances across "
            f"{n_workers} workers (a worker needs >= 1)")

    def shares(total: int, floor: int) -> List[int]:
        scale = sum(weights) or 1.0
        raw = [w / scale * total for w in weights]
        out = [max(floor, int(r)) for r in raw]
        while sum(out) > total:
            i = max(range(n_workers),
                    key=lambda j: (out[j] - raw[j], out[j]))
            if out[i] <= floor:
                break
            out[i] -= 1
        order = sorted(range(n_workers), key=lambda j: raw[j] - out[j],
                       reverse=True)
        i = 0
        while sum(out) < total:
            out[order[i % n_workers]] += 1
            i += 1
        return out

    instances = shares(cfg.max_instances, 1)
    pre_warm = shares(cfg.pre_warm, 0)
    return [Platform(platform.latency,
                     dataclasses.replace(cfg, max_instances=instances[i],
                                         pre_warm=pre_warm[i],
                                         seed=cfg.seed + i),
                     meter=platform.meter)
            for i in range(n_workers)]
