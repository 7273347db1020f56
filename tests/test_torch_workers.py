"""The worker pools in the port (``core/workers.py``) against the JAX
package's ``repro.core.workers`` on the same sequences: weight-cache hits,
misses, evictions and load seconds; every placement's choices;
``WorkerPoolExecutor`` over ``SimExecutor``\\ s on ``split_platform``
shards (completions, ``worker_stats``, ``model_cache_stats``), the
overflow at a full worker, the weight-load debit on an async worker, and
the engine's (worker, seq) delivery order and per-worker clamp.  The
control plane is plain Python on both sides, so results are held equal,
not close."""

import numpy as np
import pytest
import torch

from repro.core import workers as jw
from repro.core.engine import Completion as JCompletion
from repro.core.engine import ExecHandle as JExecHandle
from repro.core.engine import InvokerPool as JInvokerPool
from repro.core.engine import ServingEngine as JServingEngine
from repro.core.engine import SimExecutor as JSimExecutor
from repro.core.engine import uniform_pool as juniform_pool
from repro.core.invoker import Invocation as JInvocation
from repro.core.invoker import SLOAwareInvoker as JSLOAwareInvoker
from repro.core.latency import LatencyBank as JLatencyBank
from repro.core.latency import LatencyTable as JLatencyTable
from repro.core.latency import OnlineLatencyTable as JOnlineLatencyTable
from repro.core.partitioning import Patch as JPatch
from repro.data.video import Arrival as JArrival
from repro.serverless.platform import Platform as JPlatform
from repro.serverless.platform import PlatformConfig as JPlatformConfig
from repro.serverless.platform import split_platform as jsplit_platform
from repro_torch.core import workers as tw
from repro_torch.core.engine import (AsyncDeviceExecutor, Completion,
                                     ExecHandle, InvokerPool, ServingEngine,
                                     SimExecutor, slo_class, uniform_pool)
from repro_torch.core.invoker import Invocation, SLOAwareInvoker
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable)
from repro_torch.core.partitioning import Patch
from repro_torch.data.video import Arrival
from repro_torch.serverless.platform import Platform, PlatformConfig
from repro_torch.serverless.platform import split_platform
from repro_torch.launch.mesh import make_worker_meshes

#: (weight_bytes, load_s) of three models
MODELS = {"a": (4e6, 0.4), "b": (3e6, 0.3), "c": (6e6, 0.6)}
TABLE = {b: (0.02 * b, 0.002) for b in range(1, 17)}


def model_sequence(seed, n=40):
    rng = np.random.default_rng(seed)
    return [[None, "a", "b", "c", "zzz"][int(i)]
            for i in rng.choice(5, size=n, p=[0.1, 0.35, 0.3, 0.2, 0.05])]


@pytest.mark.parametrize("capacity", [5e6, 7e6, 10e6, 13e6, 1e6])
@pytest.mark.parametrize("seed", [0, 1])
def test_weight_cache_equals_jax(seed, capacity):
    """Hits, misses, the LRU eviction order, used bytes and load seconds
    after every access (a model larger than the budget loads alone)."""
    jc = jw.WeightCache(capacity, MODELS)
    tc = tw.WeightCache(capacity, MODELS)
    for model in model_sequence(seed):
        assert tc.ensure(model) == jc.ensure(model)
        assert tc.resident() == jc.resident()
        assert tc.used_bytes == jc.used_bytes
        assert tc.holds(model) == jc.holds(model)
    assert tc.stats() == jc.stats()
    assert (tc.hits, tc.misses, tc.evictions, tc.hit_rate) == \
        (jc.hits, jc.misses, jc.evictions, jc.hit_rate)
    caches = tw.weight_caches(3, capacity, MODELS)
    assert len(caches) == 3 and len({id(c) for c in caches}) == 3
    with pytest.raises(ValueError, match="capacity_bytes"):
        tw.WeightCache(0, MODELS)


class ManualWorker:
    """Submit/complete worker whose handles become ready only when the
    test releases them; every completion reports ``t_finish``."""

    def __init__(self, completion_cls, handle_cls, t_finish=1.0,
                 max_inflight=None):
        self.completion_cls, self.handle_cls = completion_cls, handle_cls
        self.t_finish = t_finish
        self.released = False
        self.submitted = []
        if max_inflight is not None:
            self.max_inflight = max_inflight

    def submit(self, inv):
        self.submitted.append(inv)
        return self.handle_cls(inv, t_finish=None)

    def ready(self, handle):
        return self.released

    def resolve(self, handle):
        return self.completion_cls(handle.invocation, self.t_finish)


def manual_pools(n, placement_of, caches=None, max_inflight=None,
                 t_finish=(1.0,)):
    """The same pool of ``n`` manual workers in both packages."""
    def workers(comp, handle):
        return [ManualWorker(comp, handle, t_finish[i % len(t_finish)],
                             max_inflight) for i in range(n)]
    jcaches = tcaches = None
    if caches is not None:
        jcaches = jw.weight_caches(n, caches, MODELS)
        tcaches = tw.weight_caches(n, caches, MODELS)
    jpool = jw.WorkerPoolExecutor(workers(JCompletion, JExecHandle),
                                  placement=placement_of(jw),
                                  weight_caches=jcaches)
    tpool = tw.WorkerPoolExecutor(workers(Completion, ExecHandle),
                                  placement=placement_of(tw),
                                  weight_caches=tcaches)
    return jpool, tpool


def invocations(seed, n=30, keys=(0.2, 0.5, 2.0)):
    """(key, model, n_patches) of a run of invocations."""
    rng = np.random.default_rng(seed)
    return [(float(rng.choice(keys)), model, int(rng.integers(1, 4)))
            for model in model_sequence(seed + 10, n)]


def make_inv(cls_inv, cls_patch, key, model, n_patches, t=0.0):
    ps = [cls_patch(0, 0, 16, 16, t_gen=t, slo=1.0)
          for _ in range(n_patches)]
    return cls_inv(t, [], ps, 0.0, "timer", key=key, model=model)


PLACEMENTS = {
    "least": lambda m: m.LeastOutstandingPlacement(),
    "round": lambda m: m.RoundRobinPlacement(),
    "affinity": lambda m: m.make_placement("affinity"),
    "reserved_keys": lambda m: m.ClassAffinityPlacement(
        reserved={0.2: (0,), 0.5: (1, 7)}),
    "reserve_two": lambda m: m.ClassAffinityPlacement(reserve_tightest=2),
    "reserved_counts": lambda m: m.ReservedClassPlacement(
        {"0.2": 1, "2.0": 2}),
    "model": lambda m: m.make_placement("model"),
}


@pytest.mark.parametrize("caches", [None, 7e6])
@pytest.mark.parametrize("n_workers", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(PLACEMENTS))
def test_placement_choices_equal_jax(name, n_workers, caches):
    """Every placement picks the same worker for every invocation, with
    resolves interleaved so outstanding counts move; the pools' counters
    and caches end equal."""
    jpool, tpool = manual_pools(n_workers, PLACEMENTS[name], caches=caches)
    jh, th = [], []
    for i, (key, model, n) in enumerate(invocations(n_workers)):
        jh.append(jpool.submit(make_inv(JInvocation, JPatch, key, model, n)))
        th.append(tpool.submit(make_inv(Invocation, Patch, key, model, n)))
        assert th[-1].worker == jh[-1].worker
        assert th[-1].load_s == jh[-1].load_s
        if i % 3 == 2:                     # retire the oldest
            for pool, hs in ((jpool, jh), (tpool, th)):
                h = hs.pop(0)
                pool.workers[h.worker].released = True
                pool.resolve(h)
                pool.workers[h.worker].released = False
        assert tpool.outstanding == jpool.outstanding
    assert tpool.n_submitted == jpool.n_submitted
    assert tpool.n_patches == jpool.n_patches
    assert tpool.model_cache_stats() == jpool.model_cache_stats()


def test_class_affinity_activates_on_a_second_class():
    """``reserve_tightest``: one class spreads over every worker; once a
    second class is seen the tightest gets the reserved worker."""
    got = {}
    for mod in (jw, tw):
        mod_inv = (JInvocation, JPatch) if mod is jw else (Invocation, Patch)
        workers = [ManualWorker(Completion, ExecHandle) for _ in range(3)]
        pool = mod.WorkerPoolExecutor(
            workers, placement=mod.ClassAffinityPlacement(
                reserve_tightest=1))
        picks = [pool.submit(make_inv(*mod_inv, key, None, 1)).worker
                 for key in (1.0, 1.0, 1.0, 2.0, 0.5, 0.5, 2.0, 1.0)]
        got[mod.__name__] = picks
    assert got["repro_torch.core.workers"] == got["repro.core.workers"]
    assert got["repro.core.workers"][:3] == [0, 1, 2]
    assert got["repro.core.workers"][4:6] == [0, 0]


def test_overflow_at_a_full_worker_equals_jax():
    """A worker's own in-flight bound is hard: a placement that keeps
    picking a full worker is overridden, as in the JAX pool."""
    class Fixed:
        def choose(self, inv, pool):
            return 0
    jpool, tpool = manual_pools(3, lambda m: Fixed(), max_inflight=2)
    for _ in range(6):
        jpool.submit(make_inv(JInvocation, JPatch, None, None, 1))
        tpool.submit(make_inv(Invocation, Patch, None, None, 1))
    assert tpool.outstanding == jpool.outstanding == [2, 2, 2]
    assert tpool.max_inflight == jpool.max_inflight == 6
    tpool.submit(make_inv(Invocation, Patch, None, None, 1))  # all full
    assert tpool.outstanding == [3, 2, 2]
    with pytest.raises(ValueError, match="placement chose worker 5"):
        class Bad:
            def choose(self, inv, pool):
                return 5
        tw.WorkerPoolExecutor([ManualWorker(Completion, ExecHandle)],
                              placement=Bad()).submit(
            make_inv(Invocation, Patch, None, None, 1))
    with pytest.raises(ValueError, match="at least one worker"):
        tw.WorkerPoolExecutor([])
    with pytest.raises(ValueError, match="weight_caches"):
        tw.WorkerPoolExecutor([ManualWorker(Completion, ExecHandle)],
                              weight_caches=tw.weight_caches(2, 1e7, MODELS))


def test_load_debit_on_an_async_worker_equals_jax():
    """An async worker's finish is unknown at submit: the weight load is
    remembered on the handle and added at resolve; the estimator sees the
    debited elapsed time, per worker and per model."""
    out = {}
    for mod, (inv_cls, patch_cls, comp, handle, table, online, bank) in (
            (jw, (JInvocation, JPatch, JCompletion, JExecHandle,
                  JLatencyTable, JOnlineLatencyTable, JLatencyBank)),
            (tw, (Invocation, Patch, Completion, ExecHandle, LatencyTable,
                  OnlineLatencyTable, LatencyBank))):
        est = bank({m: online(table(dict(TABLE))) for m in MODELS})
        workers = [ManualWorker(comp, handle, t_finish=t)
                   for t in (0.5, 0.8)]
        pool = mod.WorkerPoolExecutor(
            workers, placement=mod.make_placement("model"), estimator=est,
            weight_caches=mod.weight_caches(2, 7e6, MODELS))
        rows = []
        for key, model, n in invocations(7, n=12):
            h = pool.submit(inv_cls(0.1, [], [patch_cls(0, 0, 8, 8)] * n,
                                    0.0, "timer", key=key, model=model))
            debit = h.load_s
            pool.workers[h.worker].released = True
            c = pool.resolve(h)
            rows.append((h.worker, debit, h.load_s, c.t_finish, c.worker))
        out[mod.__name__] = (rows, pool.worker_stats(),
                             pool.model_cache_stats(),
                             {m: est.table(m).n_observations
                              for m in MODELS})
    assert out["repro_torch.core.workers"] == out["repro.core.workers"]
    rows = out["repro.core.workers"][0]
    assert any(debit > 0 for _, debit, _, _, _ in rows)
    assert all(left == 0.0 for _, _, left, _, _ in rows)


def sim_pools(n_workers, placement, models=False, online=False, seed=7):
    """The same SimExecutor pool over ``split_platform`` shards in both
    packages (one shared cost meter each)."""
    out = []
    for mod, table_cls, online_cls, bank_cls, plat_cls, cfg_cls, split, sim \
            in ((jw, JLatencyTable, JOnlineLatencyTable, JLatencyBank,
                 JPlatform, JPlatformConfig, jsplit_platform, JSimExecutor),
                (tw, LatencyTable, OnlineLatencyTable, LatencyBank, Platform,
                 PlatformConfig, split_platform, SimExecutor)):
        table = table_cls(dict(TABLE))
        base = plat_cls(table, cfg_cls(max_instances=6, pre_warm=1,
                                       cold_start_s=0.3, seed=seed))
        plats = split(base, n_workers) if n_workers > 1 else [base]
        kw = {}
        if models:
            kw = dict(model_loads={m: load for m, (_, load) in
                                   MODELS.items()},
                      model_tables={m: table_cls({b: (mu * (i + 1), s)
                                                  for b, (mu, s) in
                                                  TABLE.items()})
                                    for i, m in enumerate(MODELS)})
        est = None
        if online:
            est = (bank_cls({m: online_cls(table) for m in MODELS})
                   if models else online_cls(table))
        caches = (mod.weight_caches(n_workers, 7e6, MODELS)
                  if models else None)
        pool = mod.WorkerPoolExecutor([sim(p, **kw) for p in plats],
                                      placement=mod.make_placement(placement),
                                      estimator=est, weight_caches=caches)
        out.append((pool, base, est))
    return out


def engine_run(side, pool, est, seed, models, online):
    """Serve one random multi-class trace through ``pool``."""
    jax_side = side == "jax"
    patch_cls, arr_cls = (JPatch, JArrival) if jax_side else (Patch, Arrival)
    rng = np.random.default_rng(seed)
    arrivals = []
    for i in range(60):
        t = round(float(rng.uniform(0, 3.0)), 4)
        slo = float(rng.choice([0.3, 0.8, 2.0]))
        p = patch_cls(0, 0, int(rng.integers(16, 96)),
                      int(rng.integers(16, 96)), frame_id=i, t_gen=t,
                      slo=slo)
        arrivals.append(arr_cls(t + 0.01, p, 100.0))
    arrivals.sort(key=lambda a: a.t_arrive)
    latency = est if est is not None else (
        JLatencyTable if jax_side else LatencyTable)(dict(TABLE))
    if models:
        # per-class invokers on their model's table (the bank's, online)
        model_of = {0.3: "a", 0.8: "b", 2.0: "c"}.get
        invoker_cls = JSLOAwareInvoker if jax_side else SLOAwareInvoker
        pool_cls = JInvokerPool if jax_side else InvokerPool
        inv_pool = pool_cls(
            lambda key: invoker_cls(
                128, 128, latency.table(model_of(key)) if online
                else latency, 4), classify=slo_class, model_of=model_of)
    else:
        pool_fn = juniform_pool if jax_side else uniform_pool
        inv_pool = pool_fn(128, 128, latency, 4, classify=slo_class)
    engine = (JServingEngine if jax_side else ServingEngine)(
        inv_pool, pool, check_invariants=True)
    engine.run(arrivals)
    return engine


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("models", [False, True])
@pytest.mark.parametrize("placement", ["least", "round", "affinity",
                                       "model"])
@pytest.mark.parametrize("n_workers", [1, 2, 3])
def test_sim_pool_engine_run_equals_jax(n_workers, placement, models,
                                       online):
    """Completions (finish, worker, model), the pool's ``worker_stats``
    and ``model_cache_stats``, the platform records and the estimator's
    drift equal the JAX pool's on one trace."""
    (jpool, jbase, jest), (tpool, tbase, test) = sim_pools(
        n_workers, placement, models=models, online=online)
    je = engine_run("jax", jpool, jest, n_workers, models, online)
    te = engine_run("torch", tpool, test, n_workers, models, online)
    assert [(c.t_finish, c.worker, c.model, len(c.invocation.patches))
            for c in te.completions] == \
        [(c.t_finish, c.worker, c.model, len(c.invocation.patches))
         for c in je.completions]
    assert tpool.worker_stats() == jpool.worker_stats()
    assert tpool.model_cache_stats() == jpool.model_cache_stats()
    assert tbase.total_cost == jbase.total_cost > 0
    assert [(o.t_finish, o.model) for o in te.outcomes] == \
        [(o.t_finish, o.model) for o in je.outcomes]
    if online:
        assert sum(w["invocations"] for w in tpool.worker_stats()) == \
            len(te.completions)
        assert "drift" in tpool.worker_stats()[0]


@pytest.mark.parametrize("n_workers", [2, 3])
def test_ready_handles_deliver_in_worker_seq_order(n_workers):
    """Handles ready at one harvest deliver in (worker, seq) order, and
    each worker's finishes are clamped monotone on their own: a fast
    worker's completion is not pushed up to a slow worker's finish."""
    out = {}
    for side in ("jax", "torch"):
        mod, comp, handle, patch_cls, arr_cls = (
            (jw, JCompletion, JExecHandle, JPatch, JArrival)
            if side == "jax" else
            (tw, Completion, ExecHandle, Patch, Arrival))
        workers = [ManualWorker(comp, handle, t_finish=t)
                   for t in (5.0, 1.0, 3.0)[:n_workers]]
        pool = mod.WorkerPoolExecutor(workers,
                                      placement=mod.RoundRobinPlacement())
        table = (JLatencyTable if side == "jax" else LatencyTable)(
            dict(TABLE))
        eng = (JServingEngine if side == "jax" else ServingEngine)(
            (juniform_pool if side == "jax" else uniform_pool)(
                64, 64, table), pool)
        for i in range(6):
            eng.offer(arr_cls(0.0, patch_cls(0, 0, 32, 32, frame_id=i,
                                             t_gen=0.0, slo=1e-6), 0.0))
        for w in workers:
            w.released = True
        eng.finish()
        out[side] = [(c.invocation.patches[0].frame_id, c.worker, c.t_finish)
                     for c in eng.completions]
    assert out["torch"] == out["jax"]
    workers_in_order = [w for _, w, _ in out["torch"]]
    assert workers_in_order == sorted(workers_in_order)
    fast = [t for _, w, t in out["torch"] if w == 1]
    assert fast == [1.0] * len(fast)


def _tiny_serve_fn(params, x):
    return (torch.zeros((x.shape[0], 2, 2)),
            torch.zeros((x.shape[0], 2, 2, 4)))


def test_device_pool_shares_one_frame_store_on_cpu():
    """``device_worker_pool`` on the CPU: workers on the serve meshes of
    ``make_worker_meshes`` over the CPU (one device, both workers on it),
    one frame store, every frame released whichever worker routed its
    patches."""
    meshes = make_worker_meshes(2, devices=[torch.device("cpu")])
    pool = tw.device_worker_pool(
        2, lambda i: AsyncDeviceExecutor(
            _tiny_serve_fn, None, 64, 64, device="cpu", mesh=meshes[i],
            max_inflight=2, clock=lambda: 0.0),
        placement=tw.make_placement("round"))
    assert [w.mesh for w in pool.workers] == meshes
    assert all(w.device == torch.device("cpu") for w in pool.workers)
    assert pool.workers[0].store is pool.workers[1].store
    assert pool.max_inflight == 4
    patches = [Patch(0, 0, 32, 32, frame_id=i // 2, t_gen=0.05 * i,
                     slo=1e-6) for i in range(8)]
    for f in range(4):
        pool.add_frame(f, np.zeros((64, 64, 3), np.float32), 2)
    eng = ServingEngine(uniform_pool(64, 64, LatencyTable(dict(TABLE))),
                        pool)
    eng.run([Arrival(p.t_gen, p, 0.0) for p in patches])
    assert len(pool.frames) == 0
    assert [w["invocations"] for w in pool.worker_stats()] == [4, 4]
    assert pool.n_invocations == 8 and pool.evidence_bytes > 0


@pytest.mark.parametrize("n_data", [1, 2])
def test_device_pool_sums_data_parallel_invocations(n_data):
    """Each worker executor on its own serve-mesh slice of CPU devices
    (``make_worker_meshes``, as the JAX driver slices its mesh): an
    invocation whose canvas batch the slice's data axis split counts in
    the worker's ``n_sharded``, and the pool sums them, as the JAX pool's
    ``n_sharded`` does (``WorkerPoolExecutor._sum``)."""
    from repro_torch.launch.mesh import make_worker_meshes
    meshes = make_worker_meshes(2, [torch.device("cpu")] * (2 * n_data))
    assert [m.shape["data"] for m in meshes] == [n_data, n_data]
    pool = tw.device_worker_pool(
        2, lambda i: AsyncDeviceExecutor(
            _tiny_serve_fn, None, 64, 64, device="cpu", max_inflight=2,
            clock=lambda: 0.0, mesh=meshes[i]),
        placement=tw.make_placement("round"))
    patches = [Patch(0, 0, 32, 32, frame_id=i // 2, t_gen=0.05 * i,
                     slo=1e-6) for i in range(8)]
    for f in range(4):
        pool.add_frame(f, np.zeros((64, 64, 3), np.float32), 2)
    eng = ServingEngine(uniform_pool(64, 64, LatencyTable(dict(TABLE))),
                        pool)
    eng.run([Arrival(p.t_gen, p, 0.0) for p in patches])
    assert pool.n_invocations == 8 and len(pool.frames) == 0
    per = [w.n_sharded for w in pool.workers]
    assert pool.n_sharded == sum(per)
    assert per == ([4, 4] if n_data > 1 else [0, 0])
    assert jw.WorkerPoolExecutor.n_sharded.fget.__code__.co_names == \
        tw.WorkerPoolExecutor.n_sharded.fget.__code__.co_names
