"""The port's span log (``repro_torch.core.spans``): off, it records
nothing and changes no output; on, the executor's staging and routing,
the engine's firing and lateness and the clock's sleeps are recorded,
each span inside its parent and on its own thread."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.config import DetectorConfig
from repro_torch.core import spans
from repro_torch.core.clock import VirtualClock, WallClock
from repro_torch.core.engine import (Completion, ExecHandle, ServingEngine,
                                     make_executor, uniform_pool)
from repro_torch.core.invoker import Invocation
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import stitch
from repro_torch.data.video import Arrival
from repro_torch.launch.serve import fused_kwargs
from repro_torch.models import detector as tdet

M = 128
STAGE = ("stage.plan", "stage.pack", "stage.h2d", "stage.launch")
ROUTE = ("route.wait", "route.fused", "route.evidence")
#: the trunk's device-timed records, settled at routing (a plain trunk's
#: blocks are all global); in the order their spans closed
DEVICE = ("trunk.attn.global", "trunk")


@pytest.fixture(autouse=True)
def no_log_installed():
    spans.uninstall()
    yield
    spans.uninstall()


def test_no_log_records_nothing():
    assert spans.LOG is None
    null = spans.span("stage", spans.NEW, 3)
    assert null is spans.span("route")          # one shared null context
    with null as s:
        assert s.inv is None
    log = spans.SpanLog()
    spans.install(log)
    spans.uninstall()
    with spans.span("stage", spans.NEW):
        spans.event("fire", value="timer")
    assert log.records == []


def _detector():
    cfg = DetectorConfig(name="tiny", canvas=M, patch=32, n_layers=2,
                         d_model=64, n_heads=4, d_ff=128)
    return cfg, tdet.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))


def _serve_one(kind, fuse, log):
    """One invocation of six patches over two frames through a fresh CPU
    executor; its host outputs and, before routing, its device output."""
    cfg, params = _detector()
    kw = fused_kwargs(cfg, params) if fuse else {}
    ex = make_executor(kind, serve_fn=tdet.serve_fn(cfg), params=params,
                       canvas_m=M, canvas_n=M, device="cpu", impl="torch",
                       max_inflight=2, **kw)
    rng = np.random.default_rng(5)
    for fid in range(2):
        ex.add_frame(fid, rng.random((96, 160, 3), dtype=np.float32), 3)
    patches = [Patch(x, y, x + w, y + h, frame_id=i % 2)
               for i, (x, y, w, h) in enumerate(
                   [(0, 0, 64, 48), (40, 8, 56, 80), (96, 16, 64, 64),
                    (8, 50, 72, 40), (100, 60, 60, 36), (20, 20, 30, 30)])]
    inv = Invocation(0.0, stitch(patches, M, M), patches, 0.0, "timer")
    if log is not None:
        spans.install(log)
    try:
        handle = ex.submit(inv)
        keys = ("fused",) if fuse else ("obj", "boxes")
        device = ([handle.payload[k].clone() for k in keys]
                  if handle.payload is not None else None)
        comp = ex.resolve(handle)
    finally:
        spans.uninstall()
    return len(inv.canvases), comp.outputs, device


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kind", ["async_device", "device"])
def test_executor_spans_nest_and_leave_outputs_bit_equal(kind, fuse):
    log = spans.SpanLog()
    n_canvases, on, dev_on = _serve_one(kind, fuse, log)
    _, off, dev_off = _serve_one(kind, fuse, None)
    (det_on, pix_on), (det_off, pix_off) = on, off
    assert det_on == det_off
    assert pix_on.keys() == pix_off.keys()
    for fid in pix_on:
        for a, b in zip(pix_on[fid], pix_off[fid], strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(dev_on or [], dev_off or [], strict=True):
        assert torch.equal(a, b)

    recs = log.records
    assert None not in recs
    names = [r[0] for r in recs]
    assert set(names) == {"stage", "route", *STAGE, *ROUTE, *DEVICE}
    assert {r[4] for r in recs} == {0}             # one invocation number
    for r in recs:
        if r[0] in DEVICE:                         # zero-length, host ms
            assert r[1] == r[2] and r[5] > 0
    for top in ("stage", "route"):
        i = names.index(top)
        _, t0, t1, parent, _, value = recs[i]
        assert parent is None and value == n_canvases
        kids = [r for r in recs if r[3] == i]
        want = STAGE if top == "stage" else (
            "route.wait", "route.fused", *DEVICE, "route.evidence") \
            if fuse else ("route.wait", "route.fused", "route.wait",
                          *DEVICE, "route.evidence")
        assert [k[0] for k in kids] == list(want)
        for _, k0, k1, _, _, _ in kids:
            assert t0 <= k0 <= k1 <= t1
        assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


class _Instant:
    """A sync executor whose submit takes ``delay`` of the fake clock."""

    def __init__(self, now, delay):
        self.now, self.delay = now, delay

    def submit(self, inv):
        self.now[0] += self.delay
        comp = Completion(inv, self.now[0])
        return ExecHandle(inv, t_finish=self.now[0], completion=comp)

    def resolve(self, handle):
        return handle.completion


def _patch(t_gen, slo, x=0):
    return Patch(x, 0, x + 32, 32, t_gen=t_gen, slo=slo)


def test_engine_records_late_arrivals_and_sleeps_on_a_wall_clock():
    now = [0.0]
    clock = WallClock(time_fn=lambda: now[0],
                      sleep_fn=lambda dt: now.__setitem__(0, now[0] + dt))
    log = spans.SpanLog(clock=lambda: now[0])
    pool = uniform_pool(M, M, LatencyTable({1: (0.1, 0.0)}), max_canvases=1)
    engine = ServingEngine(pool, _Instant(now, 0.3), clock=clock)
    spans.install(log)
    # A's timer is due at 1.0 - 0.1; its invocation holds the engine to
    # 1.2, so B, due at 1.0, is taken 0.2 s late
    engine.offer(Arrival(0.0, _patch(0.0, 1.0), 1.0))
    engine.offer(Arrival(1.0, _patch(1.0, 1.0, x=40), 1.0))
    engine.finish()
    spans.uninstall()
    by = {}
    for name, t0, t1, _, _, value in log.records:
        by.setdefault(name, []).append((t0, t1, value))
    assert by["engine.sleep"][0][:2] == pytest.approx((0.0, 0.9))
    late = [(t0, t1) for t0, t1, v in by["engine.late"] if v == "arrival"]
    assert late[0] == pytest.approx((0.0, 0.0))
    assert late[1] == pytest.approx((1.0, 1.2))    # due 1.0, taken at 1.2
    timers = [t1 - t0 for t0, t1, v in by["engine.late"] if v == "timer"]
    assert timers == pytest.approx([0.0, 0.0])
    assert sum(t1 - t0 for t0, t1, _ in by["engine.sleep"]) == \
        pytest.approx(0.9 + (1.9 - 1.2))
    assert [v for _, _, v in by["fire"]] == ["timer", "timer"]


def test_fire_values_are_the_invocations_reasons():
    rng = np.random.default_rng(2)
    now = [0.0]
    pool = uniform_pool(M, M, LatencyTable({1: (0.05, 0.0), 2: (0.08, 0.0)}),
                        max_canvases=2)
    engine = ServingEngine(pool, _Instant(now, 0.0), clock=VirtualClock())
    log = spans.SpanLog()
    spans.install(log)
    arrivals = []
    for i in range(60):
        t = i * 0.02
        w, h = (int(v) for v in rng.integers(24, 100, size=2))
        arrivals.append(Arrival(t, Patch(0, 0, w, h, frame_id=i, t_gen=t,
                                         slo=float(rng.choice([0.06, 0.5]))),
                                1.0))
    engine.run(arrivals)
    spans.uninstall()
    fired = [r[5] for r in log.records if r[0] == "fire"]
    assert fired == [inv.reason for inv in engine.invocations]
    assert len(set(fired)) > 1
    # a virtual clock is never late
    assert not any(r[0] == "engine.late" for r in log.records)


def test_threads_never_cross_parents():
    log = spans.SpanLog()
    spans.install(log)
    start = threading.Barrier(4)

    def work(tag):
        start.wait()
        for _ in range(200):
            with spans.span("outer", spans.NEW, tag):
                with spans.span("inner", value=tag):
                    spans.event("leaf", value=tag)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    recs = log.records
    assert len(recs) == 4 * 200 * 3 and None not in recs
    assert len({r[4] for r in recs if r[0] == "outer"}) == 800
    for name, _, _, parent, inv, value in recs:
        if name == "outer":
            assert parent is None
            continue
        up = recs[parent]
        assert up[0] == ("outer" if name == "inner" else "inner")
        assert (up[4], up[5]) == (inv, value)
