"""The port's control plane (latency tables, invoker, clocks, frame store,
config, registries, model specs) against the JAX package's where both
exist, and on its own contracts where the port differs (H100 constants,
the torch-built detector)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import invoker as jinvoker
from repro.core import latency as jlatency
from repro.core import models as jmodels
from repro.core.partitioning import Patch as JPatch
from repro_torch.config import HardwareConfig
from repro_torch.core import clock as tclock
from repro_torch.core import invoker as tinvoker
from repro_torch.core import latency as tlatency
from repro_torch.core import models as tmodels
from repro_torch.core.config import ServeConfig, make_classify
from repro_torch.core.engine import (AsyncDeviceExecutor, DeviceExecutor,
                                     make_executor, slo_class)
from repro_torch.core.framestore import FrameStore
from repro_torch.core.partitioning import Patch

TABLE = {1: (0.05, 0.01), 2: (0.07, 0.01), 4: (0.11, 0.02), 8: (0.2, 0.03)}


@pytest.mark.parametrize("batch", [0, 1, 2, 3, 4, 6, 8, 12, 40])
def test_latency_table_matches_reference(batch):
    j = jlatency.LatencyTable(dict(TABLE))
    t = tlatency.LatencyTable(dict(TABLE))
    if batch:
        assert t.mu_sigma(batch) == j.mu_sigma(batch)
    assert t.t_slack(batch) == j.t_slack(batch)


def test_analytical_model_uses_h100_constants():
    hw = HardwareConfig()
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80 * 1024**3)
    m = tlatency.detector_latency_model(1024, 1024)
    assert m.cards == 1
    assert m.flops_per_canvas == jlatency.detector_flops(
        1024, 32, 12, 768, 3072)
    mu, sigma = m.mu_sigma(4)
    want = max(m.flops_per_canvas * 4 / (989e12 * m.mma_eff),
               (m.bytes_per_canvas * 4 + m.weight_bytes) / 3.35e12) + 0.004
    assert mu == pytest.approx(want) and sigma == pytest.approx(0.05 * want)


def test_measure_syncs_inside_the_timed_call():
    calls = []
    table = tlatency.measure(lambda b: calls.append(("run", b)), (1, 2),
                             iters=3, warmup=1,
                             sync=lambda: calls.append(("sync",)))
    assert sorted(table.table) == [1, 2]
    assert calls[:2] == [("run", 1), ("sync",)]
    assert len(calls) == 2 * 2 * 4
    assert all(mu >= 0 and sd >= 0 for mu, sd in table.table.values())


def _arrivals(seed, n=60):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.02, n))
    out = []
    for i, ti in enumerate(t):
        w, h = int(rng.integers(16, 129)), int(rng.integers(16, 129))
        out.append((float(ti), dict(x0=0, y0=0, x1=w, y1=h, frame_id=i,
                                    t_gen=float(ti) - 0.01,
                                    slo=float(rng.choice([0.2, 0.5])))))
    return out


@pytest.mark.parametrize("seed,incremental", [(0, True), (1, True),
                                              (2, False)])
def test_invoker_fires_like_reference(seed, incremental):
    jt, tt = jlatency.LatencyTable(dict(TABLE)), tlatency.LatencyTable(
        dict(TABLE))
    j = jinvoker.SLOAwareInvoker(256, 256, jt, max_canvases=3,
                                 incremental=incremental)
    t = tinvoker.SLOAwareInvoker(256, 256, tt, max_canvases=3,
                                 incremental=incremental)
    jfired, tfired = [], []
    for ti, kw in _arrivals(seed):
        for inv, out in ((j, jfired), (t, tfired)):
            fired = inv.poll(ti)
            if fired is not None:
                out.append(fired)
        jfired += j.on_patch(ti, JPatch(**kw))
        tfired += t.on_patch(ti, Patch(**kw))
        assert t.next_timer() == j.next_timer()
    for inv, out in ((j, jfired), (t, tfired)):
        last = inv.flush(10.0)
        if last is not None:
            out.append(last)
    assert len(tfired) == len(jfired) > 3
    for a, b in zip(tfired, jfired):
        assert (a.t_submit, a.reason, a.t_slack, len(a.canvases)) == \
            (b.t_submit, b.reason, b.t_slack, len(b.canvases))
        assert [p.frame_id for p in a.patches] == \
            [p.frame_id for p in b.patches]
        np.testing.assert_array_equal(a.batch_plan().records,
                                      b.batch_plan().records)


def test_virtual_and_wall_clocks():
    v = tclock.make_clock("virtual", speed=5.0)
    v.advance_to(2.0)
    v.advance_to(1.0)
    assert v.now() == 2.0 and v.virtual
    now = [0.0]
    slept = []
    w = tclock.WallClock(speed=10.0, time_fn=lambda: now[0],
                         sleep_fn=slept.append)
    w.advance_to(5.0)
    assert slept == [0.5] and w.now() == 5.0 and not w.virtual
    with pytest.raises(ValueError, match="unknown clock"):
        tclock.make_clock("sundial")
    with pytest.raises(ValueError):
        tclock.WallClock(speed=0)


def test_frame_store_refcounts_and_evicts():
    s = FrameStore(n_stripes=4)
    s.add(1, "px1", 2)
    s.add(2, "px2", 0)                 # no patches: never stored
    assert 1 in s and 2 not in s and len(s) == 1
    s.release(1)
    assert s.get(1) == "px1"
    s.release(1)
    s.release(1)                       # extra releases are no-ops
    assert len(s) == 0 and s.snapshot() == {}


def test_serve_config_round_trips_and_validates():
    cfg = ServeConfig(max_canvases=4, classify="slo",
                      executor="async_device", ingestion_window=8, fuse=True)
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.replace(max_inflight=2).max_inflight == 2
    assert make_classify("slo") is slo_class and make_classify(None) is None
    with pytest.raises(ValueError, match="unknown ServeConfig"):
        ServeConfig.from_dict({"use_pallas": True})
    with pytest.raises(ValueError):
        ServeConfig(max_inflight=0)
    with pytest.raises(ValueError, match="unknown classifier"):
        make_classify("camera")


def test_make_executor_by_name():
    kw = dict(serve_fn=None, params=None, canvas_m=64, canvas_n=64,
              device="cpu", max_inflight=3)
    assert type(make_executor("device", **kw)) is DeviceExecutor
    ex = make_executor("async_device", **kw)
    assert isinstance(ex, AsyncDeviceExecutor) and ex.max_inflight == 3
    with pytest.raises(ValueError, match="unknown executor 'workers'"):
        make_executor("workers", **kw)
    with pytest.raises(ValueError, match="unknown stitch impl"):
        make_executor("device", impl="pallas", **kw)


def test_tangram_spec_matches_reference_economics():
    t, j = tmodels.make_model("tangram"), jmodels.make_model("tangram")
    assert (t.canvas_m, t.canvas_n, t.weight_bytes, t.load_s) == \
        (j.canvas_m, j.canvas_n, j.weight_bytes, j.load_s)
    # the JAX registry's names, and the port's own ViTDet-L
    assert tmodels.model_names() == ("efficientnet_b7", "tangram",
                                     "tangram_int8", "vit_s16",
                                     "vit_s16_int8", "vitdet_l")
    table = t.latency_table(max_batch=4)
    assert sorted(table.table) == [1, 2, 3, 4]
    assert all(math.isfinite(mu) and mu > 0 for mu, _ in
               table.table.values())
    r, jr = t.reduced_arch(128), j.reduced_arch(128)
    assert {k: v for k, v in dataclasses.asdict(r).items()
            if k in dataclasses.asdict(jr)} == {
        k: v for k, v in dataclasses.asdict(jr).items()
        if k in dataclasses.asdict(r)}
    assert r.plain
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.make_model("yolo")


def test_reduced_build_serves_on_cpu():
    cfg, params, serve_fn = tmodels.make_model("tangram").build(
        canvas=128, device="cpu")
    obj, boxes = serve_fn(params, torch.zeros((2, 128, 128, 3)))
    side = 128 // cfg.patch
    assert obj.shape == (2, side, side) and boxes.shape == (2, side, side, 4)
    assert torch.isfinite(obj).all() and torch.isfinite(boxes).all()
    again = tmodels.make_model("tangram").build(canvas=128, device="cpu")[1]
    assert torch.equal(again["det_head"]["kernel"],
                       params["det_head"]["kernel"])


def test_tangram_config_defaults_equal_jax():
    """The paper's Section III-IV knobs (``config.TangramConfig``)."""
    from repro.config import TangramConfig as JTangramConfig
    from repro_torch.config import TangramConfig
    j, t = JTangramConfig(), TangramConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.canvas_m, t.canvas_n, t.zone_x, t.zone_y, t.slo_s,
            t.slack_sigmas, t.max_canvases_per_batch) == (1024, 1024, 4, 4,
                                                          1.0, 3.0, 8)


def _random_boxes(rng, n):
    """The boxes of ``tests/test_partitioning.py::test_jax_matches_host``:
    up to 11 RoIs of 5-49 pixels a side in a 400x300 frame."""
    x0 = rng.integers(0, 350, n)
    y0 = rng.integers(0, 250, n)
    return np.stack([x0, y0, x0 + rng.integers(5, 50, n),
                     y0 + rng.integers(5, 50, n)], -1).astype(np.int32)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_partition_equals_jax_and_host(seed):
    """Alg. 1 on tensors: patches and validity equal the JAX ``partition``
    (all RoIs valid, then a random fifth dropped) and its valid patches
    ``partition_host``'s, on 4x4 zones with align 8."""
    import jax.numpy as jnp
    from repro.core.partitioning import partition as jpartition
    from repro_torch.core.partitioning import partition, partition_host
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 12))
        boxes = _random_boxes(rng, n)
        for valid in (np.ones(n, bool), rng.random(n) < 0.8):
            jp, jv = jpartition(jnp.asarray(boxes), jnp.asarray(valid), 400,
                                300, 4, 4, align=8)
            tp, tv = partition(torch.from_numpy(boxes),
                               torch.from_numpy(valid), 400, 300, 4, 4,
                               align=8)
            assert tp.dtype == torch.int32 and tv.dtype == torch.bool
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        host = partition_host(boxes, 400, 300, 4, 4, align=8)
        tp, tv = partition(torch.from_numpy(boxes), torch.ones(n, dtype=bool),
                           400, 300, 4, 4, align=8)
        assert sorted(map(tuple, tp[tv].tolist())) == sorted(
            (p.x0, p.y0, p.x1, p.y1) for p in host)


def test_partition_of_no_boxes_is_empty():
    from repro_torch.core.partitioning import partition
    tp, tv = partition(torch.zeros((0, 4), dtype=torch.int32),
                       torch.zeros(0, dtype=torch.bool), 400, 300, 2, 2)
    assert tp.shape == (4, 4) and not tp.any() and not tv.any()


def test_unported_arch_ids_name_their_item():
    """``mistral-large-123b`` (246 GB in bf16) resolves, but its full
    width refuses one card, naming item 17 (its weights sharded over
    cards); the MoE ids resolve and build at reduced width."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduce_arch
    from repro_torch.models import transformer
    for arch in ("deepseek-moe-16b", "llama4-scout-17b-a16e"):
        cfg = reduce_arch(configs.get(arch))
        assert cfg.name == arch and cfg.moe is not None
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
        h, aux = transformer.forward(cfg, params,
                                     torch.zeros((1, 64), dtype=torch.long))
        assert h.shape == (1, 64, cfg.d_model) and float(aux) > 0
    mistral = configs.get("mistral-large-123b")
    assert mistral.n_layers == 88
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP item 17 \(the second half of item "
                             r"14\)") as err:
        transformer.init_params(mistral, torch.Generator().manual_seed(0),
                                "cpu")
    assert "sharded over cards" in str(err.value)
    for arch in ("vit-b16", "deit-b", "dit-s2", "dit-xl2"):
        assert configs.get(arch).name == arch
