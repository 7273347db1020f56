"""The paper's metrics in the port: ``TangramScheduler``, the baselines,
AIMD, the serverless platform and the cost model against the JAX
package's, on the same patch streams, one shared latency table and the
same ``PlatformConfig``.

The two packages' analytical latency models price different hardware, so
every test builds one table from the same numbers and hands each package
its own ``LatencyTable`` of them.  The simulation is plain Python and
numpy on both sides (the platform's jitter is one
``numpy.random.default_rng(seed)`` drawn in the same order), so the
records are required equal, not close: ``Results.summary()`` key for key,
and every ``ExecutionRecord`` field for field.
"""
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import cost as jcost
from repro.core import partitioning as jpart
from repro.core import rois as jrois
from repro.core import stitching as jstitch
from repro.core.adaptive import AIMDConfig as JAIMDConfig
from repro.core.adaptive import ClassSpec as JClassSpec
from repro.core.adaptive import pool_from_specs as jpool_from_specs
from repro.core.config import ServeConfig as JServeConfig
from repro.core.engine import DeviceExecutor as JDeviceExecutor
from repro.core.engine import ServingEngine as JServingEngine
from repro.core.engine import SimExecutor as JSimExecutor
from repro.core.latency import LatencyTable as JLatencyTable
from repro.core.latency import detector_latency_model as jlatency_model
from repro.core.partitioning import Patch as JPatch
from repro.core.scheduler import TangramScheduler as JScheduler
from repro.data.video import Arrival as JArrival
from repro.launch import serve as jserve
from repro.serverless.platform import Platform as JPlatform
from repro.serverless.platform import PlatformConfig as JPlatformConfig
from repro.serverless.platform import split_platform as jsplit_platform
from repro_torch.config import DetectorConfig
from repro_torch.core import baselines, cost, partitioning, rois, stitching
from repro_torch.core.adaptive import (AIMDConfig, AdaptiveInvokerPool,
                                       ClassSpec, adaptive_uniform_pool,
                                       pool_from_specs)
from repro_torch.core.config import ServeConfig
from repro_torch.core.engine import (DeviceExecutor, ServingEngine,
                                     SimExecutor, make_executor, slo_class)
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.scheduler import TangramScheduler
from repro_torch.data.video import Arrival
from repro_torch.models import detector as tdet
from repro_torch.serverless.platform import (Platform, PlatformConfig,
                                             split_platform)

CANVAS = 256
SLO = 1.0
#: one table for both packages: the JAX package's analytical profile of
#: the 256^2 detector, as tests/test_scheduler_baselines.py builds it
TABLE = dict(jlatency_model(CANVAS, CANVAS).build_table(16).table)


def tables(table=None, slack_sigmas=3.0):
    t = dict(table or TABLE)
    return (JLatencyTable(dict(t), slack_sigmas=slack_sigmas),
            LatencyTable(dict(t), slack_sigmas=slack_sigmas))


def make_streams(patch_cls, n_cams=2, n_frames=20, per_frame=6, seed=0,
                 slos=(SLO,)):
    """``tests/test_scheduler_baselines.py::make_streams``, with the SLO
    drawn from ``slos`` per patch (one SLO: the same streams)."""
    rng = np.random.default_rng(seed)
    streams = []
    for cam in range(n_cams):
        patches = []
        for f in range(n_frames):
            t = f / 10.0
            for _ in range(rng.integers(1, per_frame + 1)):
                w = int(rng.integers(16, 160))
                h = int(rng.integers(16, 160))
                slo = (slos[0] if len(slos) == 1
                       else slos[int(rng.integers(len(slos)))])
                patches.append(patch_cls(0, 0, w, h, frame_id=f,
                                         camera_id=cam, t_gen=t, slo=slo))
        streams.append(patches)
    return streams


def both_streams(**kw):
    return make_streams(JPatch, **kw), make_streams(Patch, **kw)


def jplatform(table, **cfg):
    return JPlatform(table, JPlatformConfig(**cfg))


def tplatform(table, **cfg):
    return Platform(table, PlatformConfig(**cfg))


# ----------------------------------------------------------- scheduler ----

SCHEDULER_CASES = {
    "default": dict(config={}, streams=dict(n_cams=3, n_frames=30)),
    "per_slo_class": dict(config=dict(classify="slo"),
                          streams=dict(slos=(0.4, 1.0, 2.0), seed=3)),
    # a slow table on one instance: the platform queues, so the tight
    # class violates and the AIMD controller acts
    "aimd": dict(config=dict(classify="slo", adaptive="aimd"),
                 streams=dict(n_cams=3, n_frames=30, slos=(0.5, 2.0),
                              seed=5),
                 table={b: (0.05 * b, 0.0) for b in range(1, 17)},
                 platform=dict(max_instances=1, cold_start_s=0.0)),
    "literal_restitch": dict(config=dict(incremental=False, max_canvases=2),
                             streams=dict(seed=1)),
    "tight_slo_small_platform": dict(
        config=dict(max_canvases=4),
        streams=dict(n_cams=3, n_frames=25, slos=(0.15,), seed=2),
        platform=dict(max_instances=2, pre_warm=0, cold_start_s=0.4,
                      straggler_prob=0.2, backup_after_sigma=1.0, seed=7)),
}


def _configs(case):
    kw = dict(case["config"])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("adaptive") == "aimd":
        jkw["adaptive"] = JAIMDConfig(patience=2)
        tkw["adaptive"] = AIMDConfig(patience=2)
    return (JServeConfig(check_invariants=True, **jkw),
            ServeConfig(check_invariants=True, **tkw))


@pytest.mark.parametrize("bandwidth", [10e6, 40e6])
@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_summary_equals_jax(case, bandwidth):
    spec = SCHEDULER_CASES[case]
    jt, tt = tables(spec.get("table"))
    jcfg, tcfg = _configs(spec)
    js, ts = both_streams(**spec["streams"])
    plat = spec.get("platform", {})
    jplat, tplat = jplatform(jt, **plat), tplatform(tt, **plat)
    want = JScheduler(CANVAS, CANVAS, jt, jplat, config=jcfg).run(
        js, bandwidth)
    got = TangramScheduler(CANVAS, CANVAS, tt, tplat, config=tcfg).run(
        ts, bandwidth)
    assert got.summary() == want.summary()
    assert got.n_patches == sum(len(s) for s in ts) > 0
    assert [dataclasses.asdict(r) for r in tplat.records] == \
        [dataclasses.asdict(r) for r in jplat.records]
    assert got.batch_sizes == want.batch_sizes
    assert got.canvas_efficiencies == want.canvas_efficiencies
    assert [(o.t_arrive, o.t_submit, o.t_finish, o.wait)
            for o in got.outcomes] == [(o.t_arrive, o.t_submit, o.t_finish,
                                        o.wait) for o in want.outcomes]


def test_aimd_pool_state_equals_jax():
    """The AIMD controller's per-class state after the same run."""
    spec = SCHEDULER_CASES["aimd"]
    jt, tt = tables(spec["table"])
    jcfg, tcfg = _configs(spec)
    js, ts = both_streams(**spec["streams"])
    jsched = JScheduler(CANVAS, CANVAS, jt, jplatform(jt, **spec["platform"]),
                        config=jcfg)
    tsched = TangramScheduler(CANVAS, CANVAS, tt,
                              tplatform(tt, **spec["platform"]), config=tcfg)
    jsched.run(js, 20e6)
    tsched.run(ts, 20e6)
    assert isinstance(tsched.pool, AdaptiveInvokerPool)
    want = {k: dataclasses.asdict(v) for k, v in jsched.pool.state.items()}
    got = {k: dataclasses.asdict(v) for k, v in tsched.pool.state.items()}
    assert got == want and any(s["violations"] for s in got.values())


def test_pool_from_specs_per_class_geometry_equals_jax():
    """Per-class canvas geometry through ``pool_from_specs``, with and
    without AIMD, on the same engine arrivals."""
    jt, tt = tables()
    for adaptive in (None, "aimd"):
        jpool = jpool_from_specs(
            {0.4: JClassSpec(192, 192, jt, max_canvases=2)},
            default=JClassSpec(CANVAS, CANVAS, jt),
            adaptive=JAIMDConfig() if adaptive else None)
        tpool = pool_from_specs(
            {0.4: ClassSpec(192, 192, tt, max_canvases=2)},
            default=ClassSpec(CANVAS, CANVAS, tt),
            adaptive=AIMDConfig() if adaptive else None)
        js, ts = both_streams(slos=(0.4, 1.0), seed=4)
        jarr = [JArrival(p.t_gen + 0.01 * i, p, 0.0)
                for i, p in enumerate(sorted(
                    (p for s in js for p in s), key=lambda p: p.t_gen))]
        tarr = [Arrival(p.t_gen + 0.01 * i, p, 0.0)
                for i, p in enumerate(sorted(
                    (p for s in ts for p in s), key=lambda p: p.t_gen))]
        jeng = JServingEngine(jpool, JSimExecutor(jplatform(jt)))
        teng = ServingEngine(tpool, SimExecutor(tplatform(tt)),
                             check_invariants=True)
        jeng.run(jarr)
        teng.run(tarr)
        assert [(o.t_submit, o.t_finish) for o in teng.outcomes] == \
            [(o.t_submit, o.t_finish) for o in jeng.outcomes]
        assert {k: inv.m for k, inv in tpool.invokers.items()} == \
            {0.4: 192, 1.0: CANVAS}
    with pytest.raises(ValueError, match="unknown SLO class"):
        pool_from_specs({0.4: ClassSpec(128, 128, tt)})._invoker(2.0)


def test_adaptive_uniform_pool_equals_jax_on_the_engine():
    jt, tt = tables()
    from repro.core.adaptive import adaptive_uniform_pool as jadaptive_pool
    js, ts = both_streams(n_cams=3, slos=(0.25, 1.0), seed=6)
    runs = []
    for pool, eng, plat, streams, P in (
            (jadaptive_pool(CANVAS, CANVAS, jt, 4, classify=lambda p: p.slo,
                            cfg=JAIMDConfig(patience=1)),
             JServingEngine, jplatform(jt, max_instances=1), js, JArrival),
            (adaptive_uniform_pool(CANVAS, CANVAS, tt, 4, classify=slo_class,
                                   cfg=AIMDConfig(patience=1)),
             ServingEngine, tplatform(tt, max_instances=1), ts, Arrival)):
        arr = [P(p.t_gen + 0.002 * i, p, 0.0) for i, p in enumerate(sorted(
            (p for s in streams for p in s), key=lambda p: p.t_gen))]
        engine = eng(pool, (JSimExecutor if P is JArrival
                            else SimExecutor)(plat))
        engine.run(arr)
        runs.append(([(o.t_submit, o.t_finish, o.violated)
                      for o in engine.outcomes],
                     {k: (s.max_canvases, s.margin, s.violations)
                      for k, s in pool.state.items()}))
    assert runs[0] == runs[1]
    assert any(v for _, _, v in runs[1][0])


# ----------------------------------------------------------- baselines ----

BASELINES = {
    "elf": lambda b, s, bw, p: b.run_elf(s, bw, p, CANVAS * CANVAS),
    "clipper": lambda b, s, bw, p: b.run_clipper(
        s, bw, p, CANVAS * CANVAS, tile_side=128, slo=SLO),
    "mark": lambda b, s, bw, p: b.run_mark(s, bw, p, CANVAS * CANVAS,
                                           tile_side=128),
    "mark_small_batch": lambda b, s, bw, p: b.run_mark(
        s, bw, p, CANVAS * CANVAS, tile_side=64, max_batch=3, timeout=0.1),
}


@pytest.mark.parametrize("bandwidth", [10e6, 40e6])
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_summary_equals_jax(name, bandwidth):
    jt, tt = tables()
    js, ts = both_streams(n_cams=3, n_frames=30, seed=2)
    jplat = jplatform(jt, straggler_prob=0.1, seed=3)
    tplat = tplatform(tt, straggler_prob=0.1, seed=3)
    want = BASELINES[name](jbaselines, js, bandwidth, jplat)
    got = BASELINES[name](baselines, ts, bandwidth, tplat)
    assert got.summary() == want.summary()
    assert got.invocations == len(tplat.records) > 0
    assert [dataclasses.asdict(r) for r in tplat.records] == \
        [dataclasses.asdict(r) for r in jplat.records]


@pytest.mark.parametrize("masked", [False, True])
def test_frame_baselines_equal_jax(masked):
    jt, tt = tables()
    frames = [dict(width=960, height=540, fg_area=20000, t_gen=f / 10.0,
                   slo=SLO, camera_id=c) for c in range(2) for f in range(12)]
    per_cam = lambda cls: [[cls(**f) for f in frames if f["camera_id"] == c]
                           for c in range(2)]
    want = jbaselines.run_frame_baseline(per_cam(jbaselines.FrameMeta),
                                         20e6, jplatform(jt), masked=masked)
    got = baselines.run_frame_baseline(per_cam(baselines.FrameMeta), 20e6,
                                       tplatform(tt), masked=masked)
    assert got.summary() == want.summary()
    assert got.name == ("masked_frame" if masked else "full_frame")


def test_batchers_fire_as_jax():
    """Clipper's AIMD target and MArk's inclusive timeout, driven
    directly."""
    clip, jclip = (baselines.ClipperBatcher(0.25, drain=0.5),
                   jbaselines.ClipperBatcher(0.25, drain=0.5))
    mark, jmark = (baselines.MArkBatcher(0.25, max_batch=3, timeout=0.2),
                   jbaselines.MArkBatcher(0.25, max_batch=3, timeout=0.2))
    fired = [[], []]
    for i, t in enumerate([0.0, 0.05, 0.2, 0.21, 0.3, 0.7, 0.71]):
        for k, (b, P) in enumerate(((clip, Patch), (jclip, JPatch))):
            for inv in b.on_patch(t, P(0, 0, 16, 16, t_gen=t, slo=0.1)):
                b.on_result(inv, t + (0.5 if i % 2 else 0.01))
                fired[k].append((inv.t_submit, len(inv.patches),
                                 inv.cost_canvases, b.target))
        for k, (b, P) in enumerate(((mark, Patch), (jmark, JPatch))):
            for inv in b.on_patch(t, P(0, 0, 16, 16, t_gen=t, slo=1.0)):
                fired[k].append((inv.t_submit, len(inv.patches),
                                 inv.cost_canvases, inv.reason))
    assert fired[0] == fired[1] and len(fired[0]) > 4
    for b, P in ((mark, Patch), (jmark, JPatch), (clip, Patch),
                 (jclip, JPatch)):
        b.on_patch(0.9, P(0, 0, 16, 16, t_gen=0.9, slo=1.0))
    assert mark.next_timer() == jmark.next_timer() == 1.1
    assert (mark.flush(1.0).t_submit, clip.flush(1.0).t_submit) == \
        (jmark.flush(1.0).t_submit, jclip.flush(1.0).t_submit)


# ---------------------------------------------------- the paper's claims ----

def _paper_runs(bandwidth=20e6):
    _, tt = tables()
    streams = make_streams(Patch, n_cams=3, n_frames=30)
    tangram = TangramScheduler(
        CANVAS, CANVAS, tt, tplatform(tt),
        config=ServeConfig(check_invariants=True)).run(streams, bandwidth)
    elf = baselines.run_elf(streams, bandwidth, tplatform(tt),
                            CANVAS * CANVAS)
    clip = baselines.run_clipper(streams, bandwidth, tplatform(tt),
                                 CANVAS * CANVAS, tile_side=128, slo=SLO)
    mark = baselines.run_mark(streams, bandwidth, tplatform(tt),
                              CANVAS * CANVAS, tile_side=128)
    return tangram, elf, clip, mark


def test_tangram_violations_within_5pct():
    """The paper's headline claim at the default setting."""
    tangram = _paper_runs()[0]
    assert tangram.violation_rate <= 0.05
    assert tangram.invocations < tangram.n_patches / 3


@pytest.mark.parametrize("bandwidth", [20e6, 40e6])
def test_tangram_cheaper_than_elf_clipper_and_mark(bandwidth):
    """Figs. 8 and 12: per-patch invocation (ELF) and padded-tile
    batching (Clipper, MArk) cost more than stitched canvases."""
    tangram, elf, clip, mark = _paper_runs(bandwidth)
    for base in (elf, clip, mark):
        assert tangram.total_cost < base.total_cost, base.name
    assert tangram.summary()["cost_usd"] < elf.summary()["cost_usd"]


# ------------------------------------------------------------ platform ----

PLATFORM_CASES = {
    "default": {},
    "stragglers_hedged": dict(straggler_prob=0.3, straggler_factor=5.0,
                              backup_after_sigma=0.5, seed=11),
    "cold_small": dict(pre_warm=0, max_instances=3, cold_start_s=0.3,
                       keep_alive_s=0.5, seed=2),
    "queueing": dict(max_instances=1, pre_warm=1, straggler_prob=0.1,
                     backup_after_sigma=2.0, seed=5),
    "container_cold": dict(container_cold_s=0.1, cold_start_s=0.4,
                           pre_warm=0, keep_alive_s=0.2, seed=9),
}


@pytest.mark.parametrize("case", sorted(PLATFORM_CASES))
def test_platform_records_equal_jax(case):
    """Every ExecutionRecord, the bill and the warm pool under the same
    submissions: the straggler draws, hedged backups, cold starts and
    per-model warm pools follow the reference draw for draw."""
    cfg = PLATFORM_CASES[case]
    table = {b: (0.04 * b + 0.01, 0.004 * b) for b in range(1, 9)}
    jt, tt = tables(table)
    jp, tp = jplatform(jt, **cfg), tplatform(tt, **cfg)
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(60):
        t += float(rng.exponential(0.08))
        size = int(rng.integers(1, 9))
        model = (None, "a", "b")[i % 3] if case == "container_cold" else None
        kw = dict(n_patches=size * 3, model=model,
                  model_load_s=0.05 if model else 0.0)
        jp.submit(t, size, **kw)
        tp.submit(t, size, **kw)
    assert [dataclasses.asdict(r) for r in tp.records] == \
        [dataclasses.asdict(r) for r in jp.records]
    assert (tp.total_cost, tp.meter.invocations, tp.meter.busy_seconds,
            tp.mean_consolidation, tp.model_stats(), tp.busy_intervals(),
            tp.utilization(t)) == \
        (jp.total_cost, jp.meter.invocations, jp.meter.busy_seconds,
         jp.mean_consolidation, jp.model_stats(), jp.busy_intervals(),
         jp.utilization(t))
    assert [dataclasses.asdict(i) for i in tp.instances] == \
        [dataclasses.asdict(i) for i in jp.instances]
    if case == "stragglers_hedged":
        assert any(r.hedged for r in tp.records)
    if case == "cold_small":
        assert sum(r.cold for r in tp.records) > 1


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 1.0]])
def test_split_platform_and_per_worker_equal_jax(weights):
    jt, tt = tables()
    cfg = dict(max_instances=10, pre_warm=4, seed=3)
    jparts = jsplit_platform(jplatform(jt, **cfg), 3, weights=weights)
    tparts = split_platform(tplatform(tt, **cfg), 3, weights=weights)
    assert [dataclasses.asdict(p.cfg) for p in tparts] == \
        [dataclasses.asdict(p.cfg) for p in jparts]
    assert len({id(p.meter) for p in tparts}) == 1
    assert dataclasses.asdict(PlatformConfig(**cfg).per_worker(3, 1)) == \
        dataclasses.asdict(JPlatformConfig(**cfg).per_worker(3, 1))
    with pytest.raises(ValueError, match="cannot shard"):
        PlatformConfig(max_instances=2).per_worker(3)


def test_cost_model_equals_jax():
    for t_f in (0.0, 0.013, 1.0, 7.5):
        assert cost.alibaba_cost(t_f) == jcost.alibaba_cost(t_f)
        assert cost.alibaba_cost(t_f, 4, 8, 12) == \
            jcost.alibaba_cost(t_f, 4, 8, 12)
    assert cost.rate_per_second() == jcost.rate_per_second()
    m, jm = cost.CostMeter(), jcost.CostMeter()
    for t_f in (0.5, 1.5, 0.01):
        assert m.charge(t_f) == jm.charge(t_f)
    assert (m.total, m.invocations, m.busy_seconds) == \
        (jm.total, jm.invocations, jm.busy_seconds)
    gpu = cost.GPUCostModel(usd_per_chip_hour=3.6)
    assert gpu.chips == 1
    assert gpu.cost(1.0) == pytest.approx(3.6 / 3600 + cost.P_REQ)
    with pytest.raises(TypeError):
        cost.GPUCostModel()                # no price is assumed


# ------------------------------------------- executors and device runs ----

def test_make_executor_sim_drops_device_keys():
    _, tt = tables()
    plat = tplatform(tt)
    ex = make_executor("sim", platform=plat, serve_fn=None, params=None,
                       canvas_m=64, canvas_n=64, device="cpu",
                       max_inflight=3, fuse=True, patch=32)
    assert type(ex) is SimExecutor and ex.platform is plat
    dev = make_executor("device", serve_fn=None, params=None, canvas_m=64,
                        canvas_n=64, device="cpu", platform=plat)
    assert type(dev) is DeviceExecutor


def test_scheduler_on_a_device_executor_equals_jax():
    """A ctor-supplied device executor is used as it is: the run's
    outcomes come from the device pipeline (here on the CPU, with a
    clock that reads 0, so timing cannot move them), and the platform
    carries only the meter, so cost and platform invocations read 0 on
    both sides."""
    cfg, params, serve_fn, rules = jserve.build_detector(canvas=CANVAS)
    tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(DetectorConfig)})
    import jax
    tparams = tdet.convert_params(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, torch.device("cpu"))
    jt, tt = tables({1: (0.02, 0.002), 2: (0.03, 0.002), 4: (0.05, 0.004)})
    js, ts = both_streams(n_frames=6, per_frame=3, seed=8)
    jex = JDeviceExecutor(serve_fn, params, CANVAS, CANVAS,
                          clock=lambda: 0.0)
    tex = DeviceExecutor(tdet.serve_fn(tcfg), tparams, CANVAS, CANVAS,
                         device="cpu", clock=lambda: 0.0)
    want = JScheduler(CANVAS, CANVAS, jt, jplatform(jt), executor=jex,
                      config=JServeConfig(max_canvases=4)).run(js, 20e6)
    got = TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt), executor=tex,
                           config=ServeConfig(max_canvases=4)).run(ts, 20e6)
    assert got.summary() == want.summary()
    assert got.invocations == 0 and got.total_cost == 0.0
    assert tex.n_invocations == jex.n_invocations > 0


def test_legacy_keywords_warn_and_forward():
    import repro_torch.core.scheduler as sched_mod
    _, tt = tables()
    sched_mod._legacy_warned = False
    with pytest.warns(DeprecationWarning, match="deprecated"):
        s = TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt),
                             max_canvases=3, classify=slo_class,
                             check_invariants=True)
    assert s.config.max_canvases == 3 and s.check_invariants
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # warned once per process
        TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt), max_canvases=2)
    with pytest.raises(TypeError, match="unexpected"):
        TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt), bogus=1)
    # shards with the legacy n_workers build and serve: two shards, a
    # worker each
    s = TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt),
                         config=ServeConfig(shards=2), n_workers=2)
    assert s.config.shards == 2 and s.config.n_workers == 2
    res = s.run(both_streams(n_cams=2, n_frames=4)[1], 20e6)
    assert res.n_patches > 0
    assert [r["workers"] for r in res.shard_stats] == [1, 1]
    # a placement instance, which a config cannot name, is an override
    from repro_torch.core.workers import RoundRobinPlacement
    rr = RoundRobinPlacement()
    s = TangramScheduler(CANVAS, CANVAS, tt, tplatform(tt), n_workers=2,
                         placement=rr)
    assert s.placement is rr and s.config.n_workers == 2


def test_serve_config_round_trips_aimd():
    cfg = ServeConfig(classify="slo", adaptive=AIMDConfig(patience=5),
                      incremental=False, quantize=True, executor="sim")
    import json
    back = ServeConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg and back.adaptive.patience == 5
    jd = JServeConfig(classify="slo", adaptive=JAIMDConfig(patience=5),
                      incremental=False, quantize=True).to_dict()
    jd.pop("use_pallas")               # the port has no Pallas switch
    assert ServeConfig.from_dict(jd) == cfg
    with pytest.raises(ValueError, match="planner requires shards"):
        ServeConfig(planner="cost")


# ------------------------------------------------- shared-module pieces ----

def test_stitching_metrics_equal_jax():
    rng = np.random.default_rng(0)
    sizes = [(int(rng.integers(8, 120)), int(rng.integers(8, 120)))
             for _ in range(40)]
    jc = jstitch.stitch([JPatch(0, 0, w, h) for w, h in sizes], 256, 256)
    tc = stitching.stitch([Patch(0, 0, w, h) for w, h in sizes], 256, 256)
    assert [c.efficiency for c in tc] == [c.efficiency for c in jc]
    assert [c.used_area for c in tc] == [c.used_area for c in jc]
    assert stitching.total_efficiency(tc) == jstitch.total_efficiency(jc)
    assert stitching.total_efficiency([]) == 0.0
    state = stitching.PackState(256, 256)
    state.reset([Patch(0, 0, w, h) for w, h in sizes])
    assert [c.placements for c in state.canvases] == \
        [c.placements for c in tc]
    state.reset()
    assert state.canvases == [] and state.count == 0
    ps = [Patch(0, 0, w, h) for w, h in sizes[:5]]
    plan = stitching.build_batch_plan(ps, stitching.stitch(ps, 256, 256),
                                      256, 256)
    assert plan.canvas_batch_shape == (plan.num_canvases, 256, 256)


def test_partitioning_pieces_equal_jax():
    rng = np.random.default_rng(1)
    frame = rng.random((96, 128, 3)).astype(np.float32)
    boxes = np.array([[3, 4, 40, 30], [50, 60, 90, 95], [100, 1, 127, 9]],
                     np.int32)
    tp = partitioning.partition_host(boxes, 128, 96, 2, 2)
    jp = jpart.partition_host(boxes, 128, 96, 2, 2)
    assert partitioning.coverage(tp, boxes) == jpart.coverage(jp, boxes)
    assert partitioning.coverage([], boxes[:0]) == 1.0
    assert partitioning.coverage(tp[:1], boxes) < 1.0
    for p in tp:
        np.testing.assert_array_equal(partitioning.patch_pixels(frame, p),
                                      jpart.patch_pixels(frame, p))
        # Alg. 1's alignment: the patch is a multiple of 16, in the frame
        lo, hi = partitioning.align_up(p.x0, p.x0 + p.w, 128)
        assert (int(lo), int(hi)) == (p.x0, p.x1)
    lo, hi = partitioning.align_up(np.array([0, 120, 5]),
                                   np.array([10, 127, 38]), 128)
    assert lo.tolist() == [0, 112, 5] and hi.tolist() == [16, 128, 53]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_rois_equals_jax_and_extract_rois(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((96, 160), bool)
    for _ in range(6):
        y, x = int(rng.integers(0, 80)), int(rng.integers(0, 140))
        mask[y:y + int(rng.integers(3, 16)),
             x:x + int(rng.integers(3, 20))] = True
    cfg, jcfg = rois.RoIConfig(max_rois=8), jrois.RoIConfig(max_rois=8)
    boxes, valid = rois.numpy_rois(mask, cfg)
    jboxes, jvalid = jrois.numpy_rois(mask, jcfg)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(valid, jvalid)
    tb, tv = rois.extract_rois(torch.from_numpy(mask), cfg)
    got = sorted(map(tuple, tb[tv].tolist()))
    assert got == sorted(map(tuple, boxes.tolist())) and len(got) > 0


# ------------------------------------------ models, pools, online tables ----

@pytest.fixture
def registered_models():
    """Two explicit-table models registered in both registries (the two
    packages' analytical profiles price different hardware), removed
    after the test."""
    from repro.core import models as jmodels
    from repro_torch.core import models as tmodels
    jmodels.make_model("tangram")             # seed both registries first
    tmodels.make_model("tangram")
    specs = {"sched_light": (0.5, 4e6, CANVAS),
             "sched_heavy": (2.0, 30e6, 2 * CANVAS)}
    for name, (scale, weight_bytes, canvas) in specs.items():
        table = {b: (mu * scale, s * scale) for b, (mu, s) in TABLE.items()}
        jmodels.register_model(jmodels.ModelSpec(
            name=name, canvas_m=canvas, canvas_n=canvas,
            weight_bytes=weight_bytes, table=JLatencyTable(dict(table))))
        tmodels.register_model(tmodels.ModelSpec(
            name=name, canvas_m=canvas, canvas_n=canvas,
            weight_bytes=weight_bytes, table=LatencyTable(dict(table))))
    yield
    for name in specs:
        jmodels._MODELS.pop(name)
        tmodels._MODELS.pop(name)


MAP = {"0.4": "sched_light", "2.0": "sched_heavy"}
POOL_CASES = {
    "model": dict(model="sched_light"),
    "model_map": dict(classify="slo", model_map=MAP, model="sched_heavy"),
    "model_map_aimd": dict(classify="slo", model_map=MAP,
                           model="sched_heavy", adaptive="aimd"),
    "workers": dict(n_workers=2),
    "online": dict(online_latency=True),
    "online_models": dict(classify="slo", model_map=MAP,
                          model="sched_light", online_latency=True),
    **{f"workers_{p}": dict(classify="slo", model_map=MAP,
                            model="sched_heavy", n_workers=2, placement=p)
       for p in ("least", "round", "affinity", "model")},
    "workers_online_models": dict(classify="slo", model_map=MAP,
                                  model="sched_light", n_workers=3,
                                  placement="model", online_latency=True),
}


@pytest.mark.parametrize("bandwidth", [10e6, 40e6])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_scheduler_models_pools_online_equal_jax(case, bandwidth,
                                                 registered_models):
    """``model`` / ``model_map``, ``n_workers`` with each placement and
    ``online_latency``: ``Results.summary()`` (per-model rows with the
    weight-cache counters, per-worker rows with drift) and every platform
    record equal the JAX scheduler's on the same streams."""
    jcfg, tcfg = _configs({"config": POOL_CASES[case]})
    js, ts = both_streams(n_cams=3, n_frames=25, slos=(0.4, 1.0, 2.0),
                          seed=11)
    jt, tt = tables()
    plat = dict(max_instances=6, pre_warm=1, cold_start_s=0.3)
    jplat, tplat = jplatform(jt, **plat), tplatform(tt, **plat)
    jsched = JScheduler(CANVAS, CANVAS, jt, jplat, config=jcfg)
    tsched = TangramScheduler(CANVAS, CANVAS, tt, tplat, config=tcfg)
    want = jsched.run(js, bandwidth)
    got = tsched.run(ts, bandwidth)
    summary = got.summary()
    assert summary == want.summary()
    assert summary["patches"] == sum(len(s) for s in ts) > 0
    if tcfg.multi_model:
        assert set(summary["models"]) <= {"sched_light", "sched_heavy"}
        assert all(o.model is not None for o in got.outcomes)
    if tcfg.n_workers > 1 or tcfg.online_latency:
        assert len(summary["per_worker"]) == tcfg.n_workers
    if tcfg.online_latency:
        assert "drift" in summary["per_worker"][0]
        assert type(tsched.estimator).__name__ == \
            type(jsched.estimator).__name__
    assert got.batch_sizes == want.batch_sizes
    assert [(o.t_submit, o.t_finish, o.model) for o in got.outcomes] == \
        [(o.t_submit, o.t_finish, o.model) for o in want.outcomes]


def test_scheduler_unmapped_class_without_default_raises(registered_models):
    _, tt = tables()
    sched = TangramScheduler(
        CANVAS, CANVAS, tt, tplatform(tt),
        config=ServeConfig(classify="slo", model_map={"0.4": "sched_light"}))
    _, ts = both_streams(slos=(1.0,))
    with pytest.raises(ValueError, match="unknown SLO class 1.0"):
        sched.run(ts, 40e6)


def test_serve_config_model_routing_equals_jax():
    for kw in (dict(), dict(model="tangram"), dict(model_map=MAP),
               dict(model_map=MAP, model="tangram")):
        j, t = JServeConfig(**kw), ServeConfig(**kw)
        assert t.multi_model == j.multi_model
        assert t.model_names() == j.model_names()
        for key in (0.4, "0.4", 2.0, 1.0, None):
            assert t.resolve_model(key) == j.resolve_model(key)
