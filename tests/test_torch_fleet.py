"""Fleet sharding in the port (``core/fleet.py``, ``sources/fleet.py``,
the scheduler's sharded path) against the JAX package's, on the same
inputs: the fleet source's arrivals record for record, the event-heap
pool's decisions (against the JAX pool's and the port's stock pool's),
planned layouts (``FleetPlan.to_dict()``), ``ShardedEngine`` transcripts
over ``SimExecutor``\\ s at 1, 2, 4 and 5 shards, and the sharded
``TangramScheduler``'s ``Results.summary()`` with its ``per_shard`` rows.
The control plane is plain Python and numpy on both sides, so every
comparison is equality, not closeness.  The port's tests mirror
``tests/test_fleet.py`` and hold the reference's properties too."""
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import fleet as jfleet
from repro.core.config import ServeConfig as JServeConfig
from repro.core.engine import ServingEngine as JServingEngine
from repro.core.engine import SimExecutor as JSimExecutor
from repro.core.engine import uniform_pool as juniform_pool
from repro.core.latency import LatencyTable as JLatencyTable
from repro.core.latency import OnlineLatencyTable as JOnlineLatencyTable
from repro.core.partitioning import Patch as JPatch
from repro.core.scheduler import TangramScheduler as JScheduler
from repro.data.video import Arrival as JArrival
from repro.serverless.platform import Platform as JPlatform
from repro.serverless.platform import PlatformConfig as JPlatformConfig
from repro.sources import FleetCameraSource as JFleetCameraSource
from repro.sources import make_source as jmake_source
from repro_torch.core import fleet as tfleet
from repro_torch.core.config import ServeConfig
from repro_torch.core.engine import ServingEngine, SimExecutor, uniform_pool
from repro_torch.core.fleet import (EqualSplitPlanner, FleetCostModel,
                                    FleetInvokerPool, FleetPlan,
                                    FleetPlanner, ShardedEngine,
                                    fleet_uniform_pool, make_planner)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import LatencyTable, OnlineLatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.scheduler import TangramScheduler
from repro_torch.core.workers import ReservedClassPlacement
from repro_torch.data.video import Arrival
from repro_torch.serverless.platform import Platform, PlatformConfig
from repro_torch.sources import FleetCameraSource, make_source

TABLE = {1: (0.05, 0.0), 2: (0.08, 0.0), 4: (0.12, 0.0), 8: (0.2, 0.0)}
GROUP = 4

#: each package's pieces under one set of names
JAX = SimpleNamespace(
    Patch=JPatch, Arrival=JArrival, ServingEngine=JServingEngine,
    SimExecutor=JSimExecutor, uniform_pool=juniform_pool,
    fleet_uniform_pool=jfleet.fleet_uniform_pool, FleetPlan=jfleet.FleetPlan,
    ShardedEngine=jfleet.ShardedEngine, Platform=JPlatform,
    PlatformConfig=JPlatformConfig, table=lambda: JLatencyTable(dict(TABLE)),
    FleetCameraSource=JFleetCameraSource, FleetPlanner=jfleet.FleetPlanner,
    FleetCostModel=jfleet.FleetCostModel,
    EqualSplitPlanner=jfleet.EqualSplitPlanner,
    OnlineLatencyTable=JOnlineLatencyTable, Scheduler=JScheduler,
    ServeConfig=JServeConfig, make_source=jmake_source)
PORT = SimpleNamespace(
    Patch=Patch, Arrival=Arrival, ServingEngine=ServingEngine,
    SimExecutor=SimExecutor, uniform_pool=uniform_pool,
    fleet_uniform_pool=fleet_uniform_pool, FleetPlan=FleetPlan,
    ShardedEngine=ShardedEngine, Platform=Platform,
    PlatformConfig=PlatformConfig, table=lambda: LatencyTable(dict(TABLE)),
    FleetCameraSource=FleetCameraSource, FleetPlanner=FleetPlanner,
    FleetCostModel=FleetCostModel, EqualSplitPlanner=EqualSplitPlanner,
    OnlineLatencyTable=OnlineLatencyTable, Scheduler=TangramScheduler,
    ServeConfig=ServeConfig, make_source=make_source)


def classify(p):
    return (p.slo, p.camera_id // GROUP)


def det_platform(ns=PORT, instances=64, seed=0):
    """Deterministic platform: sigma-0 table, no cold starts, enough
    pre-warmed instances that capacity never skews a comparison."""
    return ns.Platform(ns.table(), ns.PlatformConfig(
        max_instances=instances, pre_warm=instances, cold_start_s=0.0,
        keep_alive_s=1e9, seed=seed))


def fleet_arrivals(ns=PORT, n_cameras=40, duration_s=3.0, seed=7, **kw):
    return ns.FleetCameraSource(n_cameras=n_cameras, duration_s=duration_s,
                                seed=seed, **kw).arrivals()


def arrival_key(a):
    p = a.patch
    return (a.t_arrive, a.n_bytes, p.x0, p.y0, p.x1, p.y1, p.frame_id,
            p.camera_id, p.t_gen, p.slo)


def outcome_key(o):
    return (o.patch.camera_id, o.patch.frame_id, o.patch.x0, o.patch.y0,
            round(o.t_arrive, 9), round(o.t_submit, 9),
            round(o.t_finish, 9))


def invocation_key(inv):
    return (inv.t_submit, inv.key, inv.reason, inv.shard,
            [(p.frame_id, p.x0, p.y0) for p in inv.patches])


# ------------------------------------------------------- the fleet source ----


@pytest.mark.parametrize("kw", [
    dict(n_cameras=12, duration_s=2.0, seed=9),
    dict(n_cameras=50, duration_s=1.0, rate_sigma=1.0, sorted_by_rate=True,
         seed=1),
    dict(n_cameras=24, duration_s=2.0, rate_sigma=0.0, burst_prob=0.3,
         slos=(0.2, 0.7, 1.5), seed=4)])
def test_fleet_source_arrivals_equal_jax(kw):
    jsrc, tsrc = JFleetCameraSource(**kw), FleetCameraSource(**kw)
    want, got = jsrc.arrivals(), tsrc.arrivals()
    assert len(got) == len(want) > 0
    assert [arrival_key(a) for a in got] == [arrival_key(a) for a in want]
    assert tsrc.camera_rates() == jsrc.camera_rates()
    assert tsrc.class_rates() == jsrc.class_rates()
    assert tsrc.stats().to_dict() == jsrc.stats().to_dict()


def test_fleet_source_deterministic_sorted_and_rated():
    src = FleetCameraSource(n_cameras=12, duration_s=2.0, seed=9)
    a = src.arrivals()
    b = FleetCameraSource(n_cameras=12, duration_s=2.0, seed=9).arrivals()
    assert [(x.t_arrive, x.patch.camera_id, x.patch.frame_id) for x in a] \
        == [(x.t_arrive, x.patch.camera_id, x.patch.frame_id) for x in b]
    times = [x.t_arrive for x in a]
    assert times == sorted(times)
    rates = src.camera_rates()
    assert set(rates) == set(range(12))
    assert math.isclose(sum(rates.values()), src.total_rate())
    assert math.isclose(sum(src.class_rates().values()), src.total_rate())
    assert {x.patch.slo for x in a} == {0.5, 2.0}
    assert isinstance(make_source("fleet", n_cameras=2, duration_s=1.0),
                      FleetCameraSource)


def test_fleet_source_sorted_by_rate_is_id_correlated():
    src = FleetCameraSource(n_cameras=50, duration_s=1.0, rate_sigma=1.0,
                            sorted_by_rate=True, seed=1)
    fps = list(src.fps)
    assert fps == sorted(fps, reverse=True)
    with pytest.raises(ValueError, match="n_cameras"):
        FleetCameraSource(n_cameras=0)
    with pytest.raises(ValueError, match="slos"):
        FleetCameraSource(slos=())


# ------------------------------------------------------- pool equivalence ----


def _pool_events(ns, seed=0, n=400):
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for i in range(n):
        t += float(rng.uniform(0.0, 0.02))
        roll = rng.uniform()
        if roll < 0.70:
            cam = int(rng.integers(0, 24))
            slo = (0.2, 0.7)[cam % 2]
            w = int(rng.integers(16, 120))
            h = int(rng.integers(16, 120))
            events.append(("patch", t, ns.Patch(0, 0, w, h, frame_id=i,
                                                camera_id=cam, t_gen=t,
                                                slo=slo)))
        elif roll < 0.95:
            events.append(("poll", t, None))
        else:
            events.append(("flush", t, None))
    return events


def _drive(pool, events):
    fired, timers = [], []
    for kind, t, patch in events:
        if kind == "patch":
            fired.extend(pool.on_patch(t, patch))
        else:
            step = pool.poll if kind == "poll" else pool.flush
            while True:
                inv = step(t)
                if inv is None:
                    break
                fired.append(inv)
        timers.append(pool.next_timer())
    return [(inv.t_submit, inv.key, inv.reason,
             [p.frame_id for p in inv.patches]) for inv in fired], timers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_pool_decision_identical_to_stock_and_jax_pools(seed):
    stock = _drive(uniform_pool(256, 256, PORT.table(), classify=classify),
                   _pool_events(PORT, seed))
    fleet = _drive(fleet_uniform_pool(256, 256, PORT.table(),
                                      classify=classify),
                   _pool_events(PORT, seed))
    jax_fleet = _drive(jfleet.fleet_uniform_pool(256, 256, JAX.table(),
                                                 classify=classify),
                       _pool_events(JAX, seed))
    assert len(fleet[0]) > 0
    assert fleet == stock == jax_fleet


def test_fleet_pool_heap_compacts_under_churn():
    # every arrival to a class with a live timer stales its heap entry;
    # the stale counter compacts once dead entries exceed 2x the live
    # classes, so the heap stays O(classes), with the stock decisions
    stock = uniform_pool(256, 256, PORT.table(), classify=classify)
    fleet = fleet_uniform_pool(256, 256, PORT.table(), classify=classify)
    jax_fleet = jfleet.fleet_uniform_pool(256, 256, JAX.table(),
                                          classify=classify)
    n_classes, t, max_heap = 6, 0.0, 0
    fired = {id(stock): [], id(fleet): [], id(jax_fleet): []}
    for i in range(3000):
        t += 0.001
        for pool, cls in ((stock, Patch), (fleet, Patch),
                          (jax_fleet, JPatch)):
            p = cls(0, 0, 32, 32, frame_id=i,
                    camera_id=(i % n_classes) * GROUP, t_gen=t, slo=5.0)
            fired[id(pool)].extend(pool.on_patch(t, p))
        assert stock.next_timer() == fleet.next_timer() \
            == jax_fleet.next_timer()
        max_heap = max(max_heap, len(fleet._heap))
        assert len(fleet._heap) == len(jax_fleet._heap)
    live = len(fleet.invokers)
    assert live == n_classes
    assert max_heap <= 3 * live + 32, \
        f"heap peaked at {max_heap} entries for {live} live classes"
    for pool in (stock, fleet, jax_fleet):
        for step in (pool.poll, pool.flush):
            while True:
                inv = step(10.0)
                if inv is None:
                    break
                fired[id(pool)].append(inv)
    keys = [[(inv.t_submit, inv.key, [p.frame_id for p in inv.patches])
             for inv in fired[id(pool)]] for pool in (stock, fleet,
                                                      jax_fleet)]
    assert len(keys[0]) > 0 and keys[0] == keys[1] == keys[2]
    assert len(fleet._heap) <= 3 * live + 32


@pytest.mark.parametrize("make", [
    lambda: uniform_pool(256, 256, PORT.table(), classify=classify),
    lambda: fleet_uniform_pool(256, 256, PORT.table(), classify=classify)])
def test_fleet_pool_tie_prefers_first_registered_class(make):
    # two classes with identical timers: the first-registered class fires
    # first in the stock pool's dict-order min, and so in the heap pool
    pool = make()
    p0 = Patch(0, 0, 32, 32, camera_id=0, t_gen=0.0, slo=1.0)
    p1 = Patch(0, 0, 32, 32, camera_id=GROUP, t_gen=0.0, slo=1.0)
    assert pool.on_patch(0.0, p0) == []
    assert pool.on_patch(0.0, p1) == []
    fired = []
    while True:
        inv = pool.poll(10.0)
        if inv is None:
            break
        fired.append(inv)
    assert [inv.key for inv in fired] == [classify(p0), classify(p1)]


def test_fleet_pool_tags_models():
    pool = FleetInvokerPool(
        lambda key: SLOAwareInvoker(256, 256, PORT.table()), classify,
        model_of=lambda key: f"m{key[1]}")
    fired = pool.on_patch(0.0, Patch(0, 0, 32, 32, camera_id=GROUP,
                                     t_gen=0.0, slo=5.0))
    while True:
        inv = pool.flush(1.0)
        if inv is None:
            break
        fired.append(inv)
    assert [(inv.key, inv.model) for inv in fired] == [((5.0, 1), "m1")]
    assert pool.next_timer() == math.inf and pool.poll(10.0) is None


# ---------------------------------------------------- sharded engine ----


def build_sharded(ns, n_shards, camera_block=GROUP, n_cameras=40,
                  window=None):
    """A ShardedEngine whose camera groups respect the batching classes
    (contiguous blocks of ``camera_block`` cameras stay together)."""
    groups = [[] for _ in range(n_shards)]
    for blk in range((n_cameras + camera_block - 1) // camera_block):
        cams = range(blk * camera_block,
                     min((blk + 1) * camera_block, n_cameras))
        groups[blk % n_shards].extend(cams)
    plan = ns.FleetPlan(n_shards=n_shards,
                        camera_groups=tuple(tuple(g) for g in groups))
    engines = [ns.ServingEngine(
        ns.fleet_uniform_pool(256, 256, ns.table(), classify=classify),
        ns.SimExecutor(det_platform(ns, seed=s)), ingestion_window=window)
        for s in range(n_shards)]
    return ns.ShardedEngine(engines, plan.shard_of, plan=plan)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [7, 11])
def test_sharded_transcript_equals_jax(n_shards, seed):
    """Outcomes in merge order, invocations (with their shard tags) and
    the per-shard rows, shard for shard."""
    runs = []
    for ns in (JAX, PORT):
        sharded = build_sharded(ns, n_shards)
        sharded.run(fleet_arrivals(ns, seed=seed, burst_prob=0.3,
                                   burst_factor=4.0))
        runs.append(sharded)
    want, got = runs
    assert len(got.outcomes) > 0
    assert list(map(outcome_key, got.outcomes)) \
        == list(map(outcome_key, want.outcomes))
    assert list(map(invocation_key, got.invocations)) \
        == list(map(invocation_key, want.invocations))
    assert got.shard_stats() == want.shard_stats()
    assert got.arrivals_total == want.arrivals_total
    assert got.backlog_high_water == want.backlog_high_water


def test_one_shard_identical_to_single_engine():
    arrivals = fleet_arrivals(burst_prob=0.3, burst_factor=4.0)
    single = ServingEngine(uniform_pool(256, 256, PORT.table(),
                                        classify=classify),
                           SimExecutor(det_platform()))
    single.run(arrivals)
    sharded = build_sharded(PORT, n_shards=1)
    sharded.run(arrivals)
    assert len(sharded.outcomes) == len(single.outcomes) == len(arrivals)
    for a, b in zip(single.outcomes, sharded.outcomes):
        assert a.patch is b.patch
        assert (a.t_arrive, a.t_submit, a.t_finish) \
            == (b.t_arrive, b.t_submit, b.t_finish)
    assert len(sharded.invocations) == len(single.invocations)
    assert all(inv.shard == 0 for inv in sharded.invocations)


@pytest.mark.parametrize("n_shards", [2, 5])
def test_n_shards_route_every_patch_to_the_same_outcome(n_shards):
    # camera groups aligned to the batching classes: each class's queue
    # sees the same patches in the same order in the single engine and in
    # its shard, and t_finish is a function of (t_submit, batch)
    arrivals = fleet_arrivals()
    single = ServingEngine(uniform_pool(256, 256, PORT.table(),
                                        classify=classify),
                           SimExecutor(det_platform()))
    single.run(arrivals)
    sharded = build_sharded(PORT, n_shards=n_shards)
    sharded.run(arrivals)
    assert sorted(map(outcome_key, sharded.outcomes)) \
        == sorted(map(outcome_key, single.outcomes))
    shards_used = {inv.shard for inv in sharded.invocations}
    assert len(shards_used) > 1, "trace never exercised a second shard"


def test_cross_shard_tie_delivery_order_pinned():
    # two cameras on two shards emit identical patches at the same
    # instant: both finish together, and the merge orders shard 0 first
    def run_once(ns):
        trace = []
        for t in (0.0, 0.5):
            for cam in (0, 1):
                p = ns.Patch(0, 0, 32, 32, frame_id=int(t * 10),
                             camera_id=cam, t_gen=t, slo=0.5)
                trace.append(ns.Arrival(t, p, 0.0))
        plan = ns.FleetPlan(n_shards=2, camera_groups=((0,), (1,)))
        engines = [ns.ServingEngine(
            ns.fleet_uniform_pool(256, 256, ns.table(), classify=classify),
            ns.SimExecutor(det_platform(ns, seed=s))) for s in range(2)]
        sh = ns.ShardedEngine(engines, plan.shard_of, plan=plan)
        sh.run(trace)
        return sh.outcomes

    first, again = run_once(PORT), run_once(PORT)
    finishes = [o.t_finish for o in first]
    assert len(first) == 4
    assert finishes[0] == finishes[1] and finishes[2] == finishes[3]
    assert [o.patch.camera_id for o in first] == [0, 1, 0, 1]
    assert list(map(outcome_key, first)) == list(map(outcome_key, again)) \
        == list(map(outcome_key, run_once(JAX)))


def test_sharded_engine_aggregates_and_stats():
    sharded = build_sharded(PORT, n_shards=3, window=30)
    arrivals = fleet_arrivals()
    sharded.run(arrivals)
    assert sharded.arrivals_total == len(arrivals)
    assert sharded.backlog() == 0 and not sharded.overloaded()
    assert sharded.queued_patches() == sharded.inflight_patches() == 0
    assert sharded.ingestion_window == 90      # per-shard windows summed
    rows = sharded.shard_stats()
    assert [r["shard"] for r in rows] == [0, 1, 2]
    assert sum(r["arrivals"] for r in rows) == len(arrivals)
    assert all(r["backlog_high_water"] >= 0 for r in rows)
    assert sum(r["violations"] for r in rows) \
        == sum(o.violated for o in sharded.outcomes)
    assert all("utilization" in r for r in rows)
    json.dumps(rows)
    jsharded = build_sharded(JAX, n_shards=3, window=30)
    jsharded.run(fleet_arrivals(JAX))
    assert rows == jsharded.shard_stats()


def test_sharded_engine_requires_shards():
    with pytest.raises(ValueError, match="at least one shard"):
        ShardedEngine([], lambda cam: 0)


def test_sharded_engine_offer_and_serve_match_run():
    arrivals = fleet_arrivals(n_cameras=16, duration_s=2.0)
    ran = build_sharded(PORT, 2, n_cameras=16)
    ran.run(arrivals)
    offered = build_sharded(PORT, 2, n_cameras=16)
    for a in arrivals:
        offered.offer(a)
    offered.finish()
    served = build_sharded(PORT, 2, n_cameras=16)
    served.serve(FleetCameraSource(n_cameras=16, duration_s=2.0, seed=7))
    for other in (offered, served):
        assert list(map(outcome_key, other.outcomes)) \
            == list(map(outcome_key, ran.outcomes))
        assert len(other.completions) == len(ran.completions)


# ----------------------------------------------------------- planner ----


def skewed_rates(n=64):
    """Id-correlated heterogeneous fleet: low ids are hot."""
    return {c: 8.0 / (1.0 + c) for c in range(n)}


@pytest.mark.parametrize("case", [
    dict(rates=skewed_rates(), budget=16, n_shards=4),
    dict(rates=skewed_rates(16), budget=8, n_shards=2,
         class_rates={0.5: 3.0, 2.0: 1.0}),
    dict(rates={c: 1.0 + (c % 3) for c in range(32)}, budget=4, n_shards=4,
         camera_block=GROUP),
    dict(rates={c: 0.5 for c in range(8)}, budget=8),
    dict(rates={c: 30.0 for c in range(64)}, budget=8),
    dict(rates={c: 30.0 for c in range(64)}, budget=8, n_shards=4,
         class_rates={0.5: 900.0, 2.0: 1020.0, 5.0: 0.5})])
def test_planners_equal_jax(case):
    """Both planners' ``to_dict()`` on the same rates and one table."""
    kw = {k: case[k] for k in ("class_rates", "n_shards") if k in case}
    for planner in ("cost", "equal"):
        plans = []
        for ns, fl in ((JAX, jfleet), (PORT, tfleet)):
            cm = ns.FleetCostModel(latency=ns.table())
            p = fl.make_planner(planner, cost_model=cm,
                                worker_budget=case["budget"])
            extra = ({"camera_block": case["camera_block"]}
                     if planner == "cost" and "camera_block" in case else {})
            plans.append(p.plan(case["rates"], **kw, **extra).to_dict())
        assert plans[1] == plans[0]


def test_planner_balances_and_allocates_proportionally():
    plan = FleetPlanner(FleetCostModel(latency=PORT.table()),
                        worker_budget=16).plan(skewed_rates(), n_shards=4)
    rates = skewed_rates()
    loads = [sum(rates[c] for c in g) for g in plan.camera_groups]
    assert max(loads) < 2.0 * min(loads), \
        "LPT grouping left the fleet imbalanced"
    assert sum(plan.workers) == 16
    # an equal split piles the hot low-id cameras onto shard 0
    eq = EqualSplitPlanner(worker_budget=16).plan(skewed_rates(),
                                                 n_shards=4)
    eq_loads = [sum(rates[c] for c in g) for g in eq.camera_groups]
    assert max(eq_loads) > 2.0 * max(loads)


def test_planner_beats_equal_split_on_heterogeneous_fleet():
    budget, shards = 4, 2

    def violations(ns):
        src = ns.FleetCameraSource(n_cameras=64, duration_s=4.0,
                                   rate_sigma=1.5, sorted_by_rate=True,
                                   seed=5)
        arrivals, rates = src.arrivals(), src.camera_rates()

        def run(plan):
            engines = []
            for s in range(plan.n_shards):
                w = max(plan.workers_of(s), 1)
                engines.append(ns.ServingEngine(
                    ns.fleet_uniform_pool(256, 256, ns.table(),
                                          classify=classify),
                    ns.SimExecutor(ns.Platform(ns.table(), ns.PlatformConfig(
                        max_instances=w, pre_warm=w, cold_start_s=0.0,
                        keep_alive_s=1e9, seed=s)))))
            sh = ns.ShardedEngine(engines, plan.shard_of, plan=plan)
            sh.run(arrivals)
            return sum(o.violated for o in sh.outcomes)

        cost = ns.FleetCostModel(latency=ns.table())
        planned = ns.FleetPlanner(cost, worker_budget=budget).plan(
            rates, n_shards=shards, camera_block=GROUP)
        equal = ns.EqualSplitPlanner(cost, worker_budget=budget).plan(
            rates, n_shards=shards)
        return run(planned), run(equal)

    planned, equal = violations(PORT)
    # id-correlated load at a tight budget: the rate-aware layout spreads
    # the hot sites the contiguous split piles onto shard 0
    assert planned < equal
    assert (planned, equal) == violations(JAX)


def test_planner_camera_block_keeps_classes_together():
    rates = {c: 1.0 + (c % 3) for c in range(32)}
    plan = FleetPlanner(FleetCostModel(latency=PORT.table()),
                        worker_budget=4).plan(rates, n_shards=4,
                                              camera_block=GROUP)
    for group in plan.camera_groups:
        for b in {c // GROUP for c in group}:
            members = [c for c in range(b * GROUP, (b + 1) * GROUP)
                       if c in rates]
            assert all(c in group for c in members), \
                "a batching class was split across shards"
    with pytest.raises(ValueError, match="camera_block"):
        FleetPlanner(FleetCostModel(latency=PORT.table())).plan(
            rates, camera_block=0)
    with pytest.raises(ValueError, match="camera_rates"):
        FleetPlanner(FleetCostModel(latency=PORT.table())).plan({})


def test_planner_search_prefers_one_shard_at_trivial_load():
    rates = {c: 0.5 for c in range(8)}
    plan = FleetPlanner(FleetCostModel(latency=PORT.table()),
                        worker_budget=8).plan(rates)
    assert plan.n_shards == 1


def test_replan_folds_drift_into_the_cost_model():
    results = []
    for ns in (JAX, PORT):
        online = ns.OnlineLatencyTable(ns.table())
        for _ in range(50):
            online.observe(4, 3.0 * ns.table().mu_sigma(4)[0])
        planner = ns.FleetPlanner(ns.FleetCostModel(latency=ns.table()),
                                  worker_budget=8)
        rates = {c: 30.0 for c in range(64)}
        refreshed = planner.replan(rates, online, n_shards=4)
        baseline = planner.plan(rates, n_shards=4)
        results.append((refreshed.to_dict(), baseline.to_dict()))
    (_, _), (refreshed, baseline) = results
    assert refreshed["predicted"]["drift"] > 1.5
    assert baseline["predicted"]["drift"] == 1.0
    assert refreshed["predicted"]["shards"][0]["device_util"] \
        > baseline["predicted"]["shards"][0]["device_util"]
    assert results[1] == results[0]


def test_fleet_plan_round_trips_through_json():
    plan = FleetPlanner(FleetCostModel(latency=PORT.table()),
                        worker_budget=8).plan(
        skewed_rates(16), class_rates={0.5: 3.0, 2.0: 1.0}, n_shards=2)
    rebuilt = FleetPlan.from_dict(json.loads(json.dumps(plan.to_dict())))
    assert rebuilt == plan
    assert all(rebuilt.shard_of(c) == plan.shard_of(c) for c in range(16))
    assert rebuilt.shard_of(999) == 999 % plan.n_shards   # modulo fallback
    assert FleetPlan(n_shards=3).workers_of(2) == 1
    for bad in (dict(n_shards=0), dict(n_shards=2, camera_groups=((0,),)),
                dict(n_shards=2, workers=(1,))):
        with pytest.raises(ValueError):
            FleetPlan(**bad)


def test_make_planner_registry():
    assert isinstance(make_planner(
        "cost", cost_model=FleetCostModel(latency=PORT.table())),
        FleetPlanner)
    assert isinstance(make_planner("equal"), EqualSplitPlanner)
    with pytest.raises(ValueError, match="unknown planner"):
        make_planner("nope")
    assert tfleet.ReservedClassPlacement is ReservedClassPlacement


def test_reserved_class_placement_partitions_workers():
    placement = ReservedClassPlacement({"(0.5, 0)": 2})

    class FakePool:
        n_workers = 4
        outstanding = [5, 0, 0, 0]

    class FakeInv:
        key = (0.5, 0)

    # the reserved class stays inside its [0, 2) range although worker 1
    # is not the only idle one
    assert placement.choose(FakeInv(), FakePool()) == 1
    FakeInv.key = (2.0, 1)
    assert placement.choose(FakeInv(), FakePool()) == 2   # first free


# ------------------------------------------------- scheduler wiring ----


def _serve_fleet(ns, cfg_kw, src_kw, pc_kw, name="fleet-test"):
    sched = ns.Scheduler(256, 256, ns.table(),
                         ns.Platform(ns.table(), ns.PlatformConfig(**pc_kw)),
                         config=ns.ServeConfig(**cfg_kw))
    src = ns.make_source("fleet", **src_kw)
    return sched.serve_source(src, name=name), src


@pytest.mark.parametrize("case", [
    dict(cfg=dict(classify="slo", shards=3, planner="cost", n_workers=6,
                  source="fleet"),
         src=dict(n_cameras=24, duration_s=2.0, seed=2),
         pc=dict(max_instances=24, pre_warm=12)),
    dict(cfg=dict(shards=2, planner="equal", n_workers=2),
         src=dict(n_cameras=6, duration_s=2.0, seed=3),
         pc=dict(max_instances=8, pre_warm=4)),
    dict(cfg=dict(classify="slo", shards=4, n_workers=8,
                  online_latency=True, ingestion_window=40),
         src=dict(n_cameras=32, duration_s=2.0, seed=4, rate_sigma=1.5),
         pc=dict(max_instances=16, pre_warm=8))])
def test_scheduler_sharded_summary_equals_jax(case):
    want, _ = _serve_fleet(JAX, case["cfg"], case["src"], case["pc"])
    got, src = _serve_fleet(PORT, case["cfg"], case["src"], case["pc"])
    assert got.n_patches == src.stats().arrivals > 0
    assert got.summary() == want.summary()
    assert got.summary()["per_shard"] == want.summary()["per_shard"]
    assert list(map(outcome_key, got.outcomes)) \
        == list(map(outcome_key, want.outcomes))


def test_scheduler_sharded_path_reports_per_shard_rows():
    res, src = _serve_fleet(
        PORT, dict(classify="slo", shards=3, planner="cost", n_workers=6,
                   source="fleet"),
        dict(n_cameras=24, duration_s=2.0, seed=2),
        dict(max_instances=24, pre_warm=12))
    assert res.n_patches == src.stats().arrivals > 0
    rows = res.summary()["per_shard"]
    assert [r["shard"] for r in rows] == [0, 1, 2]
    assert sum(r["arrivals"] for r in rows) == res.n_patches
    assert sum(r["workers"] for r in rows) == 6
    json.dumps(res.summary())


def test_scheduler_sharded_equal_planner_and_rateless_fallback():
    cfg = ServeConfig(shards=2, planner="equal", n_workers=2)
    sched = TangramScheduler(256, 256, PORT.table(),
                             Platform(PORT.table(), PlatformConfig(
                                 max_instances=8, pre_warm=4)),
                             config=cfg)
    res = sched.serve_source(
        make_source("fleet", n_cameras=6, duration_s=2.0, seed=3))
    assert res.n_patches > 0 and len(res.summary()["per_shard"]) == 2
    # a source with no camera_rates() falls back to modulo routing
    streams = [[Patch(0, 0, 32, 32, frame_id=i, camera_id=cam,
                      t_gen=i * 0.2, slo=1.0) for i in range(6)]
               for cam in range(4)]
    res2 = sched.run(streams, bandwidth_bps=50e6)
    assert res2.n_patches == 24
    rows = res2.summary()["per_shard"]
    assert [r["arrivals"] for r in rows] == [12, 12]
    jsched = JScheduler(256, 256, JAX.table(),
                        JPlatform(JAX.table(), JPlatformConfig(
                            max_instances=8, pre_warm=4)),
                        config=JServeConfig(shards=2, planner="equal",
                                            n_workers=2))
    jstreams = [[JPatch(0, 0, 32, 32, frame_id=i, camera_id=cam,
                        t_gen=i * 0.2, slo=1.0) for i in range(6)]
                for cam in range(4)]
    jsched.serve_source(jmake_source("fleet", n_cameras=6, duration_s=2.0,
                                     seed=3))
    assert res2.summary() == jsched.run(jstreams,
                                        bandwidth_bps=50e6).summary()


def test_serve_config_validates_fleet_fields():
    with pytest.raises(ValueError, match="shards"):
        ServeConfig(shards=0)
    with pytest.raises(ValueError, match="planner"):
        ServeConfig(planner="cost")
    cfg = ServeConfig(shards=4, planner="equal")
    assert ServeConfig.from_dict(
        json.loads(json.dumps(cfg.to_dict()))) == cfg
    assert cfg.to_dict() == {k: v for k, v in JServeConfig(
        shards=4, planner="equal").to_dict().items() if k in cfg.to_dict()}
