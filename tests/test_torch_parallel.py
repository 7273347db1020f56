"""The parallel fleet runtime in the port (``core/parallel.py``, the
barrier and shard-view clocks, the thread-safe shared state, the device
stand-ins of ``core/devicestub.py``) against the JAX package's, and the
thread a shard against the sequential ``ShardedEngine``: transcripts over
``SimExecutor``\\ s at 1, 2, 4 and 8 shards equal the JAX engines', under
plain virtual clocks and barrier-synced ones, and the parallel scheduler's
``Results.summary()`` equals the sequential one's and the JAX scheduler's.
Mirrors ``tests/test_parallel.py``; the launch counts' lock and the
executor's stream and stand-in probes are the port's own."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import devicestub as jstub
from repro.core import parallel as jparallel
from repro.core.clock import BarrierVirtualClock as JBarrierVirtualClock
from repro.core.config import ServeConfig as JServeConfig
from repro.core.engine import ServingEngine as JServingEngine
from repro.core.engine import SimExecutor as JSimExecutor
from repro.core.engine import uniform_pool as juniform_pool
from repro.core.fleet import FleetPlan as JFleetPlan
from repro.core.fleet import ShardedEngine as JShardedEngine
from repro.core.fleet import fleet_uniform_pool as jfleet_uniform_pool
from repro.core.invoker import Invocation as JInvocation
from repro.core.latency import LatencyTable as JLatencyTable
from repro.core.partitioning import Patch as JPatch
from repro.core.scheduler import TangramScheduler as JScheduler
from repro.data.video import Arrival as JArrival
from repro.serverless.platform import Platform as JPlatform
from repro.serverless.platform import PlatformConfig as JPlatformConfig
from repro.sources import FleetCameraSource as JFleetCameraSource
from repro.sources import make_source as jmake_source
from repro_torch.core.clock import BarrierVirtualClock, WallClock
from repro_torch.core.config import ServeConfig
from repro_torch.core.cost import CostMeter, alibaba_cost
from repro_torch.core.devicestub import (DeviceFuture, StubAccelerator,
                                         VirtualAccelerator)
from repro_torch.core.engine import (AsyncDeviceExecutor, DeviceExecutor,
                                     ServingEngine, SimExecutor,
                                     uniform_pool)
from repro_torch.core.fleet import (FleetPlan, ShardedEngine,
                                    fleet_uniform_pool)
from repro_torch.core.framestore import FrameStore
from repro_torch.core.invoker import Invocation
from repro_torch.core.latency import LatencyTable, OnlineLatencyTable
from repro_torch.core.parallel import ParallelShardedEngine, ShardRunner
from repro_torch.core.partitioning import Patch
from repro_torch.core.scheduler import TangramScheduler
from repro_torch.core.workers import WorkerPoolExecutor, share_frame_store
from repro_torch.data.video import Arrival
from repro_torch.kernels import launches
from repro_torch.kernels.stitch import ops as stitch_ops
from repro_torch.serverless.platform import Platform, PlatformConfig
from repro_torch.sources import FleetCameraSource, make_source

TABLE = {1: (0.05, 0.0), 2: (0.08, 0.0), 4: (0.12, 0.0), 8: (0.2, 0.0)}
GROUP = 4


def classify(p):
    return (p.slo, p.camera_id // GROUP)


def table(jax=False):
    return (JLatencyTable if jax else LatencyTable)(dict(TABLE))


def det_platform(instances=64, seed=0, jax=False):
    return (JPlatform if jax else Platform)(table(jax), (
        JPlatformConfig if jax else PlatformConfig)(
        max_instances=instances, pre_warm=instances, cold_start_s=0.0,
        keep_alive_s=1e9, seed=seed))


def fleet_arrivals(n_cameras=40, duration_s=3.0, seed=7, jax=False, **kw):
    cls = JFleetCameraSource if jax else FleetCameraSource
    return cls(n_cameras=n_cameras, duration_s=duration_s, seed=seed,
               **kw).arrivals()


def outcome_key(o):
    return (o.patch.camera_id, o.patch.frame_id, o.patch.x0, o.patch.y0,
            round(o.t_arrive, 9), round(o.t_submit, 9),
            round(o.t_finish, 9))


def build_fleet(n_shards, parallel=False, n_cameras=40, camera_block=GROUP,
                clocks=None, queue_depth=64, jax=False):
    """One fleet, built the same way in either package and either engine
    class: camera groups aligned to the batching classes, a deterministic
    platform a shard seeded by its index."""
    groups = [[] for _ in range(n_shards)]
    for blk in range((n_cameras + camera_block - 1) // camera_block):
        cams = range(blk * camera_block,
                     min((blk + 1) * camera_block, n_cameras))
        groups[blk % n_shards].extend(cams)
    plan = (JFleetPlan if jax else FleetPlan)(
        n_shards=n_shards, camera_groups=tuple(tuple(g) for g in groups))
    engine_cls = JServingEngine if jax else ServingEngine
    pool_fn = jfleet_uniform_pool if jax else fleet_uniform_pool
    executor_cls = JSimExecutor if jax else SimExecutor
    engines = [engine_cls(pool_fn(256, 256, table(jax), classify=classify),
                          executor_cls(det_platform(seed=s, jax=jax)),
                          clock=clocks[s] if clocks else None)
               for s in range(n_shards)]
    if parallel:
        cls = (jparallel.ParallelShardedEngine if jax
               else ParallelShardedEngine)
        return cls(engines, plan.shard_of, plan=plan,
                   queue_depth=queue_depth)
    return (JShardedEngine if jax else ShardedEngine)(
        engines, plan.shard_of, plan=plan)


def stats_rows(engine):
    """shard_stats minus the utilization column."""
    return [{k: v for k, v in row.items() if k != "utilization"}
            for row in engine.shard_stats()]


# ------------------------------------------------ transcript equivalence ----


@pytest.mark.parametrize("seed,n_shards", [(7, 1), (7, 2), (7, 4), (11, 4),
                                           (3, 8)])
def test_parallel_transcript_identical_to_sequential_and_jax(seed,
                                                             n_shards):
    runs = {}
    for jax in (False, True):
        for parallel in (False, True):
            eng = build_fleet(n_shards, parallel=parallel, jax=jax)
            eng.run(fleet_arrivals(seed=seed, burst_prob=0.3,
                                   burst_factor=4.0, jax=jax))
            runs[jax, parallel] = eng
    seq, par = runs[False, False], runs[False, True]
    assert len(par.outcomes) > 0
    for eng in runs.values():
        assert list(map(outcome_key, eng.outcomes)) \
            == list(map(outcome_key, seq.outcomes))
        assert eng.shard_stats() == seq.shard_stats()
    assert sum(o.violated for o in par.outcomes) \
        == sum(o.violated for o in seq.outcomes)
    assert [inv.shard for inv in par.invocations] \
        == [inv.shard for inv in seq.invocations]


def test_parallel_transcript_identical_under_barrier_clock():
    # both arms on barrier-synced virtual members: the threaded arm meets
    # in the runners' sync(), the sequential one through finish()'s align()
    n_shards = 4
    arrivals = fleet_arrivals(seed=13)
    seq = build_fleet(n_shards, clocks=BarrierVirtualClock(n_shards).members)
    seq.run(arrivals)
    par = build_fleet(n_shards, parallel=True,
                      clocks=BarrierVirtualClock(n_shards,
                                                 timeout_s=30.0).members)
    par.run(arrivals)
    jpar = build_fleet(n_shards, parallel=True, jax=True,
                       clocks=JBarrierVirtualClock(n_shards,
                                                   timeout_s=30.0).members)
    jpar.run(fleet_arrivals(seed=13, jax=True))
    for eng in (par, jpar):
        assert list(map(outcome_key, eng.outcomes)) \
            == list(map(outcome_key, seq.outcomes))
        assert stats_rows(eng) == stats_rows(seq)
    # each shard ends at the same engine time on every arm
    times = [[e.clock.now() for e in eng.shards] for eng in (seq, par, jpar)]
    assert times[0] == times[1] == times[2]


def test_parallel_small_queue_depth_backpressures_not_deadlocks():
    arrivals = fleet_arrivals(n_cameras=16, duration_s=2.0)
    seq = build_fleet(2, n_cameras=16)
    seq.run(arrivals)
    par = build_fleet(2, parallel=True, n_cameras=16, queue_depth=1)
    par.run(arrivals)
    assert list(map(outcome_key, par.outcomes)) \
        == list(map(outcome_key, seq.outcomes))
    with pytest.raises(ValueError, match="queue_depth"):
        build_fleet(2, parallel=True, queue_depth=0)


def test_parallel_offer_path_and_empty_finish():
    arrivals = fleet_arrivals(n_cameras=8, duration_s=1.0)
    seq = build_fleet(2, n_cameras=8)
    for a in arrivals:
        seq.offer(a)
    seq.finish()
    par = build_fleet(2, parallel=True, n_cameras=8)
    for a in arrivals:
        par.offer(a)
        assert par.backlog() >= 0
    par.finish()
    assert list(map(outcome_key, par.outcomes)) \
        == list(map(outcome_key, seq.outcomes))
    # a finish with no offers (runners never started) must not hang
    empty = build_fleet(2, parallel=True, n_cameras=8)
    empty.finish()
    assert empty.outcomes == []


class Boom(Exception):
    pass


class BoomExecutor:
    def submit(self, inv):
        raise Boom("shard executor died")

    def resolve(self, handle):           # pragma: no cover
        raise AssertionError


@pytest.mark.parametrize("bad_shards", [(0, 1), (1,)])
def test_parallel_shard_error_propagates_at_finish(bad_shards):
    """A dead shard's exception is raised again at finish, whether every
    shard dies or one does while the other serves on."""
    plan = FleetPlan(n_shards=2, camera_groups=((0,), (1,)))
    engines = [ServingEngine(
        fleet_uniform_pool(256, 256, table(), classify=classify),
        BoomExecutor() if s in bad_shards
        else SimExecutor(det_platform(seed=s))) for s in range(2)]
    par = ParallelShardedEngine(engines, plan.shard_of, plan=plan,
                                queue_depth=1)
    with pytest.raises(Boom):
        par.run(fleet_arrivals(n_cameras=2, duration_s=1.0))


def test_parallel_shard_error_releases_barrier_peers():
    """A shard that dies drains its inbox, so the router reaches every
    peer, and then meets its peers at the barrier clock: the live shard
    finishes and the error surfaces before the barrier's timeout (the
    reference's runner waits at the barrier first, so the router blocks
    on the dead shard's full inbox until the barrier times out)."""
    bar = BarrierVirtualClock(2, timeout_s=5.0)
    plan = FleetPlan(n_shards=2, camera_groups=((0,), (1,)))
    engines = [ServingEngine(
        fleet_uniform_pool(256, 256, table(), classify=classify),
        BoomExecutor() if s == 0 else SimExecutor(det_platform(seed=s)),
        clock=bar.members[s]) for s in range(2)]
    par = ParallelShardedEngine(engines, plan.shard_of, plan=plan,
                                queue_depth=1)
    # enough arrivals that shard 0 dies mid-stream, with more on the way
    arrivals = fleet_arrivals(n_cameras=2, duration_s=5.0, base_fps=10.0)
    t0 = time.perf_counter()
    with pytest.raises(Boom):
        par.run(arrivals)
    assert time.perf_counter() - t0 < bar.timeout_s
    assert engines[1].outcomes


# ------------------------------------------------------------- clocks ----


def test_barrier_clock_align_lifts_all_members():
    for cls in (BarrierVirtualClock, JBarrierVirtualClock):
        bar = cls(3, t0=1.0)
        bar.members[0].advance_to(2.0)
        bar.clock(2).advance_to(7.0)
        bar.align()
        assert [m.now() for m in bar.members] == [7.0, 7.0, 7.0]
        bar.members[1].advance_to(9.0)
        bar.members[1].advance_to(3.0)           # monotone
        bar.align()
        assert [m.now() for m in bar.members] == [9.0, 9.0, 9.0]
    with pytest.raises(ValueError, match="parties"):
        BarrierVirtualClock(0)


def test_barrier_clock_threaded_sync_rendezvous():
    bar = BarrierVirtualClock(4, timeout_s=30.0)
    times = [1.0, 4.0, 2.5, 3.0]
    seen = []

    def worker(i):
        m = bar.members[i]
        m.advance_to(times[i])
        m.sync()
        seen.append(m.now())

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert seen == [4.0] * 4
    assert bar.members[0].virtual and bar.virtual


def test_barrier_clock_sync_times_out_loudly():
    bar = BarrierVirtualClock(2, timeout_s=0.05)
    with pytest.raises(RuntimeError, match="timed out"):
        bar.members[0].sync()                 # the peer never arrives


def test_wall_clock_shard_view_shares_timeline():
    ticks = iter(np.arange(0.0, 100.0, 0.01))
    slept = []
    base = WallClock(speed=50.0, time_fn=lambda: float(next(ticks)),
                     sleep_fn=slept.append)
    a, b = base.shard_view(), base.shard_view()
    assert a.speed == base.speed and a._epoch == base._epoch
    assert a._time_fn is base._time_fn and a._sleep_fn is base._sleep_fn
    t0 = a.now()
    a.advance_to(t0 + 5.0)
    assert slept and a.now() >= t0 + 5.0
    # b reads the same timeline through its own floor
    assert b.now() >= t0
    assert b._floor != a._floor and not a.virtual


# ------------------------------------------------ shared-state safety ----


@pytest.fixture
def interleave():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)        # force aggressive interleaving
    yield
    sys.setswitchinterval(old)


def _threads(target, n, *args):
    threads = [threading.Thread(target=target, args=(i,) + args)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_cost_meter_concurrent_billing_exact_to_the_cent(interleave):
    meter = CostMeter()
    n_threads, n_charges, t_f = 8, 400, 0.125
    _threads(lambda i: [meter.charge(t_f) for _ in range(n_charges)],
             n_threads)
    total_charges = n_threads * n_charges
    assert meter.invocations == total_charges
    assert meter.busy_seconds == pytest.approx(total_charges * t_f)
    sequential = CostMeter()
    for _ in range(total_charges):
        sequential.charge(t_f)
    assert round(meter.total, 2) == round(sequential.total, 2)
    assert meter.total == pytest.approx(
        total_charges * alibaba_cost(t_f), rel=1e-12)


def test_frame_store_concurrent_release_drains_exactly(interleave):
    store = FrameStore()
    n_frames, refs_per_frame, n_threads = 64, 8, 8
    for f in range(n_frames):
        store.add(f, np.zeros(4), refs_per_frame)
    assert len(store) == n_frames
    assert store.refs_snapshot() == {f: refs_per_frame
                                     for f in range(n_frames)}

    def release_all(offset):
        for f in range(n_frames):
            store.release((f + offset) % n_frames)

    _threads(release_all, n_threads)
    # 8 threads x 1 release each a frame == exactly the 8 refs
    assert len(store) == 0 and store.refs_snapshot() == {}
    assert store.get(0) is None and 0 not in store


def test_online_latency_table_concurrent_observe_keeps_invariants():
    online = OnlineLatencyTable(table(), alpha=0.25)
    rng = np.random.default_rng(0)
    samples = [(int(b), float(e)) for b, e in
               zip(rng.integers(1, 9, 400), rng.uniform(0.01, 0.4, 400))]

    def observer(worker):
        for b, e in samples:
            online.observe(b, e, worker=worker)
            online.mu_sigma(b)

    _threads(observer, 4)
    assert online.n_observations == 4 * len(samples)
    for b in (1, 2, 4, 8):
        mu, sigma = online.mu_sigma(b)
        assert np.isfinite(mu) and mu > 0 and sigma >= 0


def test_launch_counts_exact_under_threads(interleave):
    """Every wrapper counts through one locked helper, so concurrent shard
    threads lose no launch; the plain versions count nothing."""
    launches.reset_launches()
    n_threads, n_each = 8, 2000
    _threads(lambda i: [launches.count_launch("stitch")
                        for _ in range(n_each)], n_threads)
    assert launches.LAUNCHES["stitch"] == n_threads * n_each
    launches.reset_launches()
    assert set(launches.LAUNCHES.values()) == {0}
    slots = torch.zeros((2, 8, 8, 3))
    records = torch.zeros((1, 2, 6), dtype=torch.int32)

    def plain(i):
        for _ in range(20):
            c = stitch_ops.stitch_canvases(slots, records, 16, 16)
            stitch_ops.unstitch_patches(c, records, 2, 8, 8)

    _threads(plain, 4)
    assert set(launches.LAUNCHES.values()) == {0}


# --------------------------------------------------- scheduler wiring ----


def _serve(parallel, jax=False, clock="virtual"):
    cfg = dict(classify="slo", shards=2, planner="cost", n_workers=4,
               source="fleet", parallel=parallel, clock=clock,
               wall_speed=1e6)
    sched = (JScheduler if jax else TangramScheduler)(
        256, 256, table(jax), (JPlatform if jax else Platform)(
            table(jax), (JPlatformConfig if jax else PlatformConfig)(
                max_instances=24, pre_warm=12)),
        config=(JServeConfig if jax else ServeConfig)(**cfg))
    src = (jmake_source if jax else make_source)(
        "fleet", n_cameras=16, duration_s=2.0, seed=2)
    return sched.serve_source(src, name="fleet-par")


def test_scheduler_parallel_matches_sequential_and_jax_results():
    seq, par, jpar = _serve(False), _serve(True), _serve(True, jax=True)
    assert par.n_patches == seq.n_patches > 0
    assert list(map(outcome_key, par.outcomes)) \
        == list(map(outcome_key, seq.outcomes))
    assert par.total_cost == pytest.approx(seq.total_cost)
    assert par.summary() == seq.summary() == jpar.summary()
    assert len(par.summary()["per_shard"]) == 2


def test_scheduler_parallel_wall_clock_shard_views():
    """``parallel`` under a wall clock gives each shard a view of one
    timeline; every patch is still served."""
    sched = TangramScheduler(256, 256, table(), Platform(table()),
                             config=ServeConfig(shards=3, parallel=True,
                                                clock="wall",
                                                wall_speed=1e4))
    clocks = sched._shard_clocks(3)
    assert len({c._epoch for c in clocks}) == 1
    assert len({id(c) for c in clocks}) == 3
    res = _serve(True, clock="wall")
    assert res.n_patches == len(res.outcomes) > 0


def test_serve_config_parallel_validation_and_roundtrip():
    with pytest.raises(ValueError, match="parallel"):
        ServeConfig(parallel=True)
    cfg = ServeConfig(shards=4, parallel=True)
    assert ServeConfig.from_dict(
        json.loads(json.dumps(cfg.to_dict()))) == cfg


def test_shard_runner_counts_and_stop():
    eng = ServingEngine(
        fleet_uniform_pool(256, 256, table(), classify=classify),
        SimExecutor(det_platform()))
    runner = ShardRunner(0, eng, queue_depth=8)
    runner.start()
    arrivals = fleet_arrivals(n_cameras=4, duration_s=1.0)
    runner.submit(arrivals)
    runner.stop()
    runner.join(timeout=30.0)
    assert runner.error is None and not runner.is_alive()
    assert runner.submitted == runner.consumed == len(arrivals)
    assert runner.pending() == 0
    assert len(eng.outcomes) == len(arrivals)
    assert eng.queued_patches() == eng.inflight_patches() == 0


# ------------------------------------------ executors: streams, stand-ins ----


def _patches(n, slo=1e-6, spacing=0.01, cls=Patch):
    return [cls(0, 0, 32, 32, frame_id=i, t_gen=round(spacing * i, 4),
                slo=slo) for i in range(n)]


def _arrivals(ps, cls=Arrival):
    return [cls(p.t_gen, p, 0.0) for p in ps]


def test_executor_refuses_a_stream_of_another_device():
    class CudaStream:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="stream on cuda:0"):
        DeviceExecutor(lambda p, c: None, None, 64, 64, device="cpu",
                       stream=CudaStream())


def test_executor_legacy_execute_shims():
    inv = Invocation(0.5, [], _patches(1), 0.0, "late")
    sim = SimExecutor(det_platform())
    assert sim.execute(inv).t_finish == pytest.approx(0.5 + TABLE[1][0])
    pool = uniform_pool(64, 64, table())
    patch = Patch(0, 0, 32, 32, frame_id=7, t_gen=0.0, slo=5.0)
    assert pool.on_patch(0.0, patch) == []
    inv = pool.flush(0.25)
    with StubAccelerator(service_s=0.0) as stub:
        dev = DeviceExecutor(stub.serve_fn, None, 64, 64, device="cpu",
                             clock=lambda: 0.0)
        dev.add_frame(7, np.ones((64, 64, 3), np.float32), 1)
        assert dev._refs == {7: 1}
        comp = dev.execute(inv)
    assert comp.t_finish == 0.25 and list(comp.outputs[1]) == [7]
    assert comp.outputs[1][7][0].shape == (32, 32, 3)
    dev.on_complete(comp)
    assert dev._refs == {} and dev.frames == {}


def test_stub_futures_drive_the_async_executor():
    """A stand-in's futures answer ``query()``: the async executor keeps
    up to ``max_inflight`` invocations in flight on a slow stub, never
    more, and delivers every completion."""
    with StubAccelerator(service_s=0.015) as stub:
        dev = AsyncDeviceExecutor(stub.serve_fn, None, 64, 64, device="cpu",
                                  max_inflight=3)
        ps = _patches(10)
        for p in ps:
            dev.add_frame(p.frame_id, np.ones((64, 64, 3), np.float32), 1)
        eng = ServingEngine(uniform_pool(64, 64, table()), dev)
        eng.run(_arrivals(ps))
        assert stub.n_calls == len(eng.invocations)
    assert eng.inflight_high_water <= 3
    assert eng.inflight_high_water >= 2, \
        "the burst never overlapped: the async path ran synchronously"
    assert len(eng.completions) == len(eng.invocations)
    assert len(eng.outcomes) == len(ps)
    assert dev.frames == {} and dev._refs == {}


def test_stub_future_probe_and_host_copy():
    with StubAccelerator(service_s=0.05, grid=3) as stub:
        obj, boxes = stub.serve_fn(None, torch.zeros((2, 8, 8, 3)))
        assert isinstance(obj, DeviceFuture) and not obj.query()
        assert tuple(obj.cpu().shape) == (2, 3, 3)      # waits for the call
        assert obj.query() and boxes.query()
        assert boxes.result().shape == (2, 3, 3, 4)
    jfut = jstub.StubAccelerator(service_s=0.0, grid=3)
    with jfut:
        jobj, _ = jfut.serve_fn(None, np.zeros((2, 8, 8, 3)))
        np.testing.assert_array_equal(obj.result(), np.asarray(jobj))


def test_slow_stub_worker_does_not_pin_fast_workers_completions():
    """Two stub workers with unequal service times: the fast worker's
    completion is delivered while the slow one is still in flight."""
    with StubAccelerator(service_s=0.5) as slow, \
            StubAccelerator(service_s=0.02) as fast:
        workers = [AsyncDeviceExecutor(s.serve_fn, None, 64, 64,
                                       device="cpu", max_inflight=4)
                   for s in (slow, fast)]
        share_frame_store(workers)

        class Fixed:
            def __init__(self):
                self.order = iter([0, 1, 1, 1])

            def choose(self, inv, pool):
                return next(self.order)

        pool = WorkerPoolExecutor(workers, placement=Fixed())
        ps = _patches(3, spacing=0.05)
        ps.append(Patch(0, 0, 32, 32, frame_id=3, t_gen=0.35, slo=1e-6))
        eng = ServingEngine(uniform_pool(64, 64, table()), pool,
                            clock=WallClock(speed=1.0))
        eng.run(_arrivals(ps))
    assert len(eng.completions) == 4
    assert eng.completions[0].worker == 1
    assert {c.worker for c in eng.completions} == {0, 1}


@pytest.mark.parametrize("service", [0.05, "batch"])
def test_virtual_accelerator_equals_jax(service):
    fn = (lambda b: 0.02 * b) if service == "batch" else service
    runs = []
    for jax in (False, True):
        dev = (jstub.VirtualAccelerator if jax else VirtualAccelerator)(fn)
        pool = (juniform_pool if jax else uniform_pool)(64, 64, table(jax))
        eng = (JServingEngine if jax else ServingEngine)(pool, dev)
        ps = _patches(8, slo=0.3, spacing=0.04,
                      cls=JPatch if jax else Patch)
        eng.run(_arrivals(ps, JArrival if jax else Arrival))
        runs.append((list(map(outcome_key, eng.outcomes)), dev.per_batch,
                     dev.n_calls, dev.queue_free))
    assert runs[0] == runs[1]
    assert runs[0][2] > 0
    inv = JInvocation(0.0, [], _patches(2, cls=JPatch), 0.0, "late")
    assert jstub.VirtualAccelerator(0.1).submit(inv).t_finish == \
        VirtualAccelerator(0.1).submit(Invocation(
            0.0, [], _patches(2), 0.0, "late")).t_finish
