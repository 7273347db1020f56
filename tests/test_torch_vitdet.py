"""ViTDet-L on the port's detector path (``vitdet_l``): the trunk against
its plain float32 reference (``models/vitdet_reference.py``) at a small
size whose grid is not a multiple of the window, the window partition,
the relative-position tables, K6's refusal of logit terms, the parameter
count, the reduced arch, and the trunk's device-timed span records."""
import dataclasses
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.core import spans
from repro_torch.core.engine import make_executor
from repro_torch.core.invoker import Invocation
from repro_torch.core.models import make_model
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import stitch
from repro_torch.launch.serve import fused_kwargs
from repro_torch.models import attention as attn
from repro_torch.models import detector, vit
from repro_torch.models import vitdet_reference as ref
from repro_torch.param import count_params, map_tree

CPU = torch.device("cpu")
DEVICE_RECORDS = ("trunk", "trunk.attn.window", "trunk.attn.global")


@pytest.fixture(autouse=True)
def no_log_installed():
    spans.uninstall()
    yield
    spans.uninstall()


def reduced(canvas=160):
    """The registry's reduced ViTDet-L: 4 blocks of width 85 (4 heads of
    21), windows of 3, blocks 1 and 3 global; at canvas 160 a 10x10 grid,
    padded to 12x12."""
    return make_model("vitdet_l").reduced_arch(canvas)


def seeded(cfg, seed=0):
    """Seeded weights with the zero-initialised biases drawn too."""
    g = torch.Generator().manual_seed(seed)
    params = detector.init_params(cfg, g, CPU)
    return map_tree(lambda t: t if t.abs().max() else
                    0.05 * torch.randn(t.shape, generator=g), params), g


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_forward_tokens_matches_reference(dtype, tol):
    """The port's trunk and head against the reference on the same
    weights (bf16's rounded), the widest gap over the reference's largest
    magnitude within ROADMAP's tolerance of the dtype."""
    cfg = reduced()
    side = cfg.canvas // cfg.patch
    windows = [cfg.block_window(i) for i in range(cfg.n_layers)]
    assert side % cfg.window and 0 in windows and cfg.window in windows
    params, g = seeded(cfg)
    tokens = torch.randn(2, side * side, cfg.d_model, generator=g)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = map_tree(lambda t: t.to(getattr(torch, dtype)), params)
    got = detector.forward_tokens(cfg, params, tokens).float()
    want = ref.forward_tokens(cfg, params, tokens)
    assert got.shape == want.shape == (2, side, side, 5)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    # the terms are not lost in the tolerance: each departure moves the
    # head far past it
    for kw in (dict(use_rel_pos=False), dict(windows=[0] * cfg.n_layers)):
        other = ref.forward_tokens(cfg, params, tokens, **kw)
        assert float((other - want).abs().max()) \
            > 20 * tol * float(want.abs().max())


@pytest.mark.parametrize("side,window", [(10, 3), (8, 4), (7, 14)])
def test_window_partition_round_trips(side, window):
    x = torch.randn(2, side * side, 6)
    w = vit.window_partition(x, side, window)
    n = -(-side // window)
    assert w.shape == (2 * n * n, window * window, 6)
    want, pad_hw = ref.window_partition(x.reshape(2, side, side, 6), window)
    assert torch.equal(w, want.reshape(w.shape))
    assert pad_hw == (n * window, n * window)
    padded = torch.ones(2, side, side, 1)
    mask = vit.window_partition(padded.reshape(2, side * side, 1), side,
                                window)
    assert int(mask.sum()) == 2 * side * side        # the padding is zeros
    assert torch.equal(vit.window_unpartition(w, side, window), x)


def test_rel_pos_table_indexes_by_offset():
    size, dh = 5, 3
    table = torch.arange((2 * size - 1) * dh, dtype=torch.float32).reshape(
        2 * size - 1, dh)
    got = attn.rel_pos_table(table, size)
    for i in range(size):
        for j in range(size):
            assert torch.equal(got[i, j], table[i - j + size - 1])
    assert torch.equal(got, ref.get_rel_pos(size, size, table))
    with pytest.raises(ValueError, match="serves a grid of side 5, not 4"):
        attn.rel_pos_table(table, 4)


@pytest.mark.parametrize("impl", ["flash", "torch"])
def test_k6_refuses_relative_positions(impl):
    cfg = reduced(128)
    params, g = seeded(cfg)
    lp = params["trunk"]["layers"][0]["attn"]
    x = torch.randn(2, 9, cfg.d_model, generator=g)
    with pytest.raises(ValueError, match="takes no relative-position"):
        attn.encoder_attention(lp, x, compute_dtype=torch.float32,
                               impl=impl, grid=(3, 3))


def test_n_params_counts_every_leaf():
    full = make_model("vitdet_l").arch
    assert full.n_params == count_params(detector.param_specs(full)) \
        == 307_432_453
    small = reduced()
    assert small.n_params == count_params(detector.param_specs(small))
    layers = detector.param_specs(full)["trunk"]["layers"]
    assert [lp["attn"]["rel_pos_h"].shape for lp in layers[4:7]] == \
        [(27, 64), (127, 64), (27, 64)]
    assert layers[0]["attn"]["bq"].shape == (16, 64)


def test_published_widths_and_the_reduced_arch_keep_the_mechanism():
    a = make_model("vitdet_l").arch
    assert (a.canvas, a.patch, a.n_layers, a.d_model, a.n_heads, a.d_ff,
            a.window, a.rel_pos, a.attn_bias, a.gelu, a.param_dtype) == \
        (1024, 16, 24, 1024, 16, 4096, 14, True, True, "erf", "bfloat16")
    assert [i for i in range(24) if not a.block_window(i)] == [5, 11, 17, 23]
    r = make_model("vitdet_l").reduced_arch(128)
    assert (r.window, r.global_every, r.rel_pos, r.attn_bias, r.gelu) == \
        (3, 2, True, True, "erf")
    assert [r.block_window(i) for i in range(r.n_layers)] == [3, 0, 3, 0]
    cfg, params, serve_fn = make_model("vitdet_l").build(canvas=128,
                                                         device="cpu")
    obj, boxes = serve_fn(params, torch.rand(2, 128, 128, 3))
    assert obj.shape == (2, 8, 8) and bool(torch.isfinite(boxes).all())


def _invocation(frames=2):
    rng = np.random.default_rng(5)
    patches = [Patch(x, y, x + w, y + h, frame_id=i % frames)
               for i, (x, y, w, h) in enumerate(
                   [(0, 0, 64, 48), (40, 8, 56, 80), (96, 16, 64, 64),
                    (8, 50, 72, 40)])]
    pixels = [rng.random((96, 160, 3), dtype=np.float32)
              for _ in range(frames)]
    return Invocation(0.0, stitch(patches, 128, 128), patches, 0.0,
                      "timer"), pixels


def _serve(n_invocations, log):
    cfg, params, serve_fn = make_model("vitdet_l").build(canvas=128,
                                                         device="cpu")
    ex = make_executor("async_device", serve_fn=serve_fn, params=params,
                       canvas_m=128, canvas_n=128, device="cpu",
                       impl="torch", **fused_kwargs(cfg, params))
    if log is not None:
        spans.install(log)
    try:
        for _ in range(n_invocations):
            inv, pixels = _invocation()
            for fid, px in enumerate(pixels):
                ex.add_frame(fid, px, 2)
            ex.resolve(ex.submit(inv))
    finally:
        spans.uninstall()


def test_device_records_once_an_invocation():
    log = spans.SpanLog()
    _serve(2, log)
    recs = [r for r in log.records if r[0] in DEVICE_RECORDS]
    stages = {r[4] for r in log.records if r[0] == "stage"}
    assert stages == {0, 1}
    for inv in stages:
        mine = [r for r in recs if r[4] == inv]
        assert sorted(r[0] for r in mine) == sorted(DEVICE_RECORDS)
        by = {r[0]: r for r in mine}
        assert all(r[1] == r[2] and r[5] > 0 for r in mine)
        # the attention records lie inside the trunk's time
        assert by["trunk.attn.window"][5] + by["trunk.attn.global"][5] \
            <= by["trunk"][5]
        # written at routing, under the invocation's route span
        assert log.records[by["trunk"][3]][0] == "route"
    assert log._device == {}


def test_without_a_log_the_trunk_makes_no_event_and_allocates_nothing(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made a device-timed span")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(spans, "_DeviceSpan", refuse)
    _serve(1, None)
    x = torch.zeros(1)
    assert spans.device_span("trunk", x) is spans.span("stage")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with spans.device_span("trunk.attn.window", x):
                pass
            spans.settle(3)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == spans.__file__ and s.size_diff]
    assert grown == []


def test_on_a_card_the_records_are_events_on_the_current_stream(
        monkeypatch):
    """The card's path, with fake events: one recorded on the current
    stream at each edge, their elapsed times summed at routing."""
    made = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t, self.synced = None, False
            made.append(self)

        def record(self, stream):
            assert stream == "stream"
            self.t = len(made)

        def synchronize(self):
            self.synced = True

        def elapsed_time(self, end):
            return float(end.t - self.t)

    class OnCard:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: "stream")
    log = spans.SpanLog()
    spans.install(log)
    with spans.span("stage", spans.NEW):
        for _ in range(3):
            with spans.device_span("trunk.attn.window", OnCard()):
                pass
    with spans.device_span("trunk", OnCard()):     # no invocation: none
        pass
    spans.settle(0)
    assert len(made) == 6 and all(e.synced for e in made[1::2])
    got = [r for r in log.records if r[0] == "trunk.attn.window"]
    assert len(got) == 1 and got[0][4] == 0 and got[0][5] == 3.0
