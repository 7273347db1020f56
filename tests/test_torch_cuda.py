"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one (a
CUDA kernel has no CPU mode); the file imports neither JAX nor the JAX
package, so it runs on a host with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.reduced import reduce_arch
from repro_torch.core import gmm
from repro_torch.core import sequence_packing
from repro_torch.core.config import ServeConfig
from repro_torch.core.engine import (InvokerPool, ModelRuntime, ServingEngine,
                                     data_devices, make_executor, slo_class,
                                     uniform_pool)
from repro_torch.core.invoker import SLOAwareInvoker
from repro_torch.core.latency import LatencyTable
from repro_torch.core.models import make_model
from repro_torch.core.partitioning import Patch
from repro_torch.core.scheduler import TangramScheduler
from repro_torch.core.workers import device_worker_pool, make_placement
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.data import loader
from repro_torch.kernels.attention import flash as flash_kernels
from repro_torch.launch.mesh import make_worker_meshes
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.launches import LAUNCHES, reset_launches
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.stitch import fused_embed
from repro_torch.kernels.stitch import ops
from repro_torch.kernels.stitch import stitch as kernels
from repro_torch.launch import train as train_lib
from repro_torch.launch.serve import (build_detector, fused_fields,
                                      fused_kwargs)
from repro_torch.models import transformer
from repro_torch.models.quantize import quantize_params
from repro_torch.param import map_tree, replace_leaves, sorted_leaves
from repro_torch.serverless.platform import Platform
from repro_torch.sources import make_source
from repro_torch.training import optimizer as opt
from repro_torch.training.train_state import value_and_grad

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plan(kind, m, rng):
    if kind == "random":
        sizes = [(int(rng.integers(8, m // 2 + 1)),
                  int(rng.integers(8, m // 2 + 1))) for _ in range(20)]
    elif kind == "flush":
        sizes = [(m // 2, m // 2)] * 4 + [(m, m), (m - 24, 16), (24, m)]
    else:
        sizes = []
    patches = [Patch(0, 0, w, h) for w, h in sizes]
    return build_batch_plan(patches, stitch(patches, m, m), m, m), patches


@pytest.mark.parametrize("kind", ["random", "flush", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_bit_exact_against_plain(cuda, dtype, kind):
    m = 1024
    rng = np.random.default_rng(11)
    plan, patches = _plan(kind, m, rng)
    crops = [rng.integers(0, 120, size=(p.h, p.w, 3)).astype(np.float32)
             for p in patches]
    slots = torch.from_numpy(ops.pack_plan_host(crops, plan)).to(
        cuda, DTYPES[dtype])
    rec = torch.from_numpy(plan.records).to(cuda)
    before = dict(kernels.LAUNCHES)
    got = ops.stitch_canvases(slots, rec, m, m, impl="cuda")
    assert torch.equal(got, ops.stitch_canvases(slots, rec, m, m,
                                                impl="torch"))
    args = (plan.slot_capacity, plan.hmax, plan.wmax)
    back = ops.unstitch_patches(got, rec, *args, impl="cuda")
    assert torch.equal(back, ops.unstitch_patches(got, rec, *args,
                                                  impl="torch"))
    launched = 0 if kind == "empty" else 1
    assert kernels.LAUNCHES["stitch"] == before["stitch"] + launched
    assert kernels.LAUNCHES["unstitch"] == before["unstitch"] + launched


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    slots = torch.zeros((2, 8, 8, 3), device=cuda)
    rec = torch.zeros((1, 2, 6), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="records"):
        ops.stitch_canvases(slots, rec.long(), 64, 64)
    with pytest.raises(ValueError, match="dtype"):
        ops.stitch_canvases(slots.double(), rec, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stitch_canvases(slots.transpose(1, 2), rec, 64, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.stitch_canvases(slots, rec.cpu(), 64, 64)


@pytest.mark.parametrize("kind", ["random", "flush", "invalid", "empty"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_fused_kernels_against_plain(cuda, dtype, tol, kind):
    """K4 within 1e-4 (f32 weights, TF32 off in the plain matmul) or 2e-2
    (bf16, one output ulp) of its plain version; K3 within 1e-5 with equal
    hit masks, on the main path's widths (canvas 1024, patch 32, d 768)."""
    m, patch, d = 1024, 32, 768
    rng = np.random.default_rng(12)
    plan, patches = _plan("random" if kind == "invalid" else kind, m, rng)
    crops = [rng.normal(size=(p.h, p.w, 3)).astype(np.float32)
             for p in patches]
    slots = torch.from_numpy(ops.pack_plan_host(crops, plan)).to(cuda)
    records = plan.records.copy()
    if kind == "invalid":
        records[..., 0] = 0
    rec = torch.from_numpy(records).to(cuda)
    wdt = DTYPES[dtype]
    kernel = torch.from_numpy(
        rng.normal(size=(patch * patch * 3, d)).astype(np.float32)
        / np.sqrt(patch * patch * 3)).to(cuda, wdt)
    bias = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        cuda, wdt)
    before = dict(kernels.LAUNCHES)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = ops.stitch_embed(slots, rec, kernel, bias, m, m, patch,
                               impl="cuda")
        want = ops.stitch_embed(slots, rec, kernel, bias, m, m, patch,
                                impl="torch")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == wdt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if kind == "invalid":
        assert torch.equal(got, bias.expand_as(got))

    side = m // patch
    raw = torch.from_numpy(rng.normal(
        size=(plan.num_canvases, side, side, 5)).astype(np.float32)).to(
            cuda, wdt)
    grids = ops.unstitch_decode(raw, rec, patch, plan.slot_capacity,
                                impl="cuda")
    plain = ops.unstitch_decode(raw, rec, patch, plan.slot_capacity,
                                impl="torch")
    assert torch.equal(grids[..., 0] > 0, plain[..., 0] > 0)
    torch.testing.assert_close(grids, plain, atol=1e-5, rtol=1e-5)
    launched = 0 if kind == "empty" else 1
    assert kernels.LAUNCHES["stitch_embed"] == (before["stitch_embed"]
                                                + launched)
    assert kernels.LAUNCHES["unstitch_decode"] == (before["unstitch_decode"]
                                                   + launched)


def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda):
    slots = torch.zeros((2, 8, 8, 3), device=cuda)
    rec = torch.zeros((1, 2, 6), dtype=torch.int32, device=cuda)
    kernel = torch.zeros((32 * 32 * 3, 16), device=cuda)
    bias = torch.zeros((16,), device=cuda)
    cases = [
        ((slots.double(), rec, kernel, bias, 64, 64), "dtype"),
        ((slots, rec, kernel.half(), bias.half(), 64, 64), "dtype"),
        ((slots, rec, kernel, bias.bfloat16(), 64, 64), "dtype"),
        ((slots, rec.long(), kernel, bias, 64, 64), "dtype"),
        ((slots, rec.cpu(), kernel, bias, 64, 64), "expected"),
        ((slots, rec, kernel.t(), bias, 64, 64), "contiguous"),
        ((slots, rec, kernel[:100], bias, 64, 64), "fit"),
        ((slots, rec, kernel, bias, 48, 64), "multiple"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            ops.stitch_embed(*args, 32, impl="cuda")
    raw = torch.zeros((1, 2, 2, 5), device=cuda)
    with pytest.raises(ValueError, match="5 channels"):
        ops.unstitch_decode(raw[..., :4].contiguous(), rec, 32, 2)
    with pytest.raises(ValueError, match="record rows"):
        ops.unstitch_decode(raw, torch.cat([rec, rec]), 32, 2)
    with pytest.raises(ValueError, match="dtype"):
        ops.unstitch_decode(raw.half(), rec, 32, 2)


def _unmatched(a, b, score_tol, box_tol, threshold=0.5):
    """Detections of ``a`` without a partner in ``b`` (same frame, score
    within ``score_tol``, box within ``box_tol`` px) whose score is not
    within ``score_tol`` of the threshold."""
    bad = []
    for fid, dets in a.items():
        free = list(b.get(fid, []))
        for score, box in dets:
            hit = next((i for i, (s, bx) in enumerate(free)
                        if abs(s - score) <= score_tol and max(
                            abs(x - y) for x, y in zip(box, bx)) <= box_tol),
                       None)
            if hit is not None:
                free.pop(hit)
            elif abs(score - threshold) > score_tol:
                bad.append((fid, score, box))
    return bad


def _served_on_card(cuda, executor, fuse, quantize=False):
    """The small driver detector (int8-resident with ``quantize``) served
    on the card through the kernels and through the plain versions; checks
    the launches and returns both runs' routed outputs."""
    frames = {}
    src = make_source("synthetic", n_frames=16, canvas=128, slo=0.3,
                      device=cuda, frame_sink=lambda f, px, n:
                      frames.__setitem__(f, (px, n)))
    arrivals = list(src.events(None))
    cfg, params, serve_fn = build_detector(128, quantize=quantize,
                                           device=cuda)
    table = LatencyTable({1: (0.02, 0.002), 4: (0.05, 0.004)})
    fused = fused_kwargs(cfg, params) if fuse else {}
    outs = []
    for impl in (None, "torch"):
        before = dict(kernels.LAUNCHES)
        ex = make_executor(executor, serve_fn=serve_fn, params=params,
                           canvas_m=128, canvas_n=128, device=cuda,
                           impl=impl, clock=lambda: 0.0, **fused)
        routed = []
        release = ex.on_complete

        def on_complete(comp, routed=routed, release=release):
            routed.append(comp.outputs)
            release(comp)

        ex.on_complete = on_complete
        for fid, (px, n) in frames.items():
            ex.add_frame(fid, px, n)
        ServingEngine(uniform_pool(128, 128, table, max_canvases=4),
                      ex).run(arrivals)
        assert len(ex.frames) == 0
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        paths = (("stitch_embed", "unstitch_decode") if fuse
                 else ("stitch", "unstitch"))
        assert all((launched[k] > 0) == (impl is None and k in paths)
                   for k in launched), launched
        outs.append(routed)
    assert len(outs[0]) == len(outs[1]) > 0
    return outs


def _assert_same_routing(outs, fuse):
    for (dets_k, px_k), (dets_p, px_p) in zip(*outs):
        if fuse:
            assert not _unmatched(dets_k, dets_p, 1e-4, 1e-3)
            assert not _unmatched(dets_p, dets_k, 1e-4, 1e-3)
        else:
            assert dets_k == dets_p
        assert set(px_k) == set(px_p)
        for fid in px_p:
            for a, b in zip(px_k[fid], px_p[fid]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("executor", ["device", "async_device"])
def test_executor_on_card_matches_plain_run(cuda, executor, fuse):
    """The small driver detector served on the card: kernels and plain
    versions route the same detections and evidence.  The executors' clock
    is pinned so completions deliver in submit order in both runs (with
    measured wall times, two invocations may finish in either order).
    Unfused, the kernels are copies and the detections equal; fused, K4
    sums in another order than the plain matmul (float32 here), so each
    detection must have a partner within 1e-4 in score and 1e-3 px, or
    lie within 1e-4 of the threshold."""
    _assert_same_routing(_served_on_card(cuda, executor, fuse), fuse)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("executor", ["device", "async_device"])
def test_int8_executor_on_card_matches_plain_run(cuda, executor, fuse):
    """The same with the detector's trunk int8-resident (``--quantize``):
    K1-K4 take the same inputs (the patch embed stays full precision), so
    the same bounds hold."""
    _assert_same_routing(_served_on_card(cuda, executor, fuse,
                                         quantize=True), fuse)


def test_scheduler_on_card_device_executor(cuda):
    """``TangramScheduler`` with a fused device executor on the card: every
    patch served once, K4/K3 launched, and the platform carries only the
    meter (cost and platform invocations 0)."""
    cfg, params, serve_fn = build_detector(256, device=cuda)
    table = LatencyTable({1: (0.02, 0.002), 4: (0.05, 0.004)})
    ex = make_executor("device", serve_fn=serve_fn, params=params,
                       canvas_m=256, canvas_n=256, device=cuda,
                       **fused_kwargs(cfg, params))
    rng = np.random.default_rng(0)
    streams = [[Patch(0, 0, int(rng.integers(16, 128)),
                      int(rng.integers(16, 128)), frame_id=f, camera_id=c,
                      t_gen=f / 10.0, slo=1.0)
                for f in range(8) for _ in range(3)] for c in range(2)]
    before = dict(kernels.LAUNCHES)
    res = TangramScheduler(256, 256, table, Platform(table), executor=ex,
                           config=ServeConfig(max_canvases=4)).run(
        streams, 40e6)
    s = res.summary()
    assert s["patches"] == 48 and s["invocations"] == 0
    assert s["cost_usd"] == 0.0 and 0 < s["mean_canvas_eff"] <= 1
    assert kernels.LAUNCHES["stitch_embed"] > before["stitch_embed"]
    assert ex.n_invocations == len(res.batch_sizes) > 0


def _gmm_case(kind, h, w, rng):
    """A mixture state and a frame as numpy arrays: random (weights
    normalised, half the pixels near a component's mean), or full of ties
    (equal weights and variances with x == mu; equal weights with nothing
    matched; a 2-way tie behind an unmatched heavy component)."""
    n = h * w
    if kind == "random":
        wt = rng.random((n, 3)).astype(np.float32) + 0.01
        wt /= wt.sum(axis=1, keepdims=True)
        mu = rng.random((n, 3)).astype(np.float32)
        var = rng.uniform(1e-4, 0.05, (n, 3)).astype(np.float32)
        near = mu[np.arange(n), rng.integers(0, 3, n)]
        x = np.where(rng.random(n) < 0.5, near + rng.normal(0, 0.05, n),
                     rng.random(n)).astype(np.float32)
    else:
        k = np.arange(n) % 3
        x = np.linspace(0.1, 0.9, n, dtype=np.float32)
        wt = np.full((n, 3), np.float32(1) / np.float32(3), np.float32)
        mu = np.repeat(x[:, None], 3, axis=1)
        var = np.full((n, 3), 0.04, np.float32)
        mu[k == 1] += 2.0
        wt[k == 2] = np.array([0.5, 0.25, 0.25], np.float32)
        mu[k == 2, 0] += 0.6
    state = {"w": wt.reshape(h, w, 3), "mu": mu.reshape(h, w, 3),
             "var": var.reshape(h, w, 3)}
    return state, x.reshape(h, w)


@pytest.mark.parametrize("kind,h,w", [
    ("random", 1, 1), ("random", 7, 13), ("random", 2160, 3840),
    ("ties", 7, 13), ("ties", 2160, 3840)])
def test_gmm_kernel_bit_equal_to_plain(cuda, kind, h, w):
    """K5 against its plain version over 3 frames, state carried: w, mu,
    var and the mask equal to the bit, at ragged and 4K sizes."""
    rng = np.random.default_rng(13)
    state, x = _gmm_case(kind, h, w, rng)
    got = want = gmm_ops.state_from_numpy(state, cuda)
    for i in range(3):
        frame = torch.from_numpy(x if i == 0 else rng.random(
            (h, w)).astype(np.float32)).to(cuda)
        before = kernels.LAUNCHES["gmm_update"]
        got, fg = gmm_ops.gmm_update(got, frame)           # CUDA -> K5
        assert kernels.LAUNCHES["gmm_update"] == before + 1
        want, fg_plain = gmm_ops.gmm_update(want, frame, impl="torch")
        assert kernels.LAUNCHES["gmm_update"] == before + 1
        for key in ("w", "mu", "var"):
            assert torch.equal(got[key], want[key]), (key, i)
        assert fg.dtype == torch.bool and torch.equal(fg, fg_plain)


def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    state = gmm.init_state(4, 8, device=cuda)
    frame = torch.full((4, 8), 0.5, device=cuda)
    bad = [
        (dict(state, w=state["w"].double()), frame, "dtype"),
        (state, frame.double(), "dtype"),
        (dict(state, mu=state["mu"].transpose(0, 1).contiguous()
              .transpose(0, 1)), frame, "contiguous"),
        (state, frame.t().contiguous(), "shape"),
        (dict(state, var=state["var"][..., :2].contiguous()), frame,
         "shape"),
        (dict(state, w=state["w"].cpu()), frame, "expected"),
        (state, frame[None], "frame must be"),
    ]
    for st, fr, match in bad:
        with pytest.raises(ValueError, match=match):
            gmm_ops.gmm_update(st, fr)
    with pytest.raises(ValueError, match="components"):
        gmm_ops.gmm_update(state, frame, cfg=gmm.GMMConfig(n_components=4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gmm_ops.gmm_update(state, frame.cpu(), impl="cuda")


def test_camera_on_card_runs_k5_once_per_frame(cuda):
    """The synthetic camera on the card launches K5 once per frame and
    gives the arrivals and frames of its plain run."""
    runs = []
    for impl in (None, "torch"):
        frames = {}
        before = kernels.LAUNCHES["gmm_update"]
        src = make_source("synthetic", n_frames=14, canvas=128, slo=1.0,
                          device=cuda, gmm_impl=impl,
                          frame_sink=lambda f, px, n:
                          frames.__setitem__(f, (px, n)))
        arrivals = list(src.events(None))
        launched = kernels.LAUNCHES["gmm_update"] - before
        assert launched == (14 if impl is None else 0)
        runs.append((arrivals, frames))
    (a_k, f_k), (a_p, f_p) = runs
    assert len(a_k) == len(a_p) > 0
    for x, y in zip(a_k, a_p):
        assert (x.t_arrive, x.n_bytes, x.patch) == (y.t_arrive, y.n_bytes,
                                                    y.patch)
    assert set(f_k) == set(f_p)
    for fid in f_k:
        np.testing.assert_array_equal(f_k[fid][0], f_p[fid][0])


# ------------------------------------------------------------ K6 and K7 ----

ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(rng, shapes, dtype, device):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device, dtype) for s in shapes]


def _packed_segments(rng, b, s):
    """Segment ids of requests packed into rows of ``s`` tokens by the
    port's sequence packer, the unused tail a segment of its own."""
    lengths = [int(n) for n in rng.integers(1, s // 2, size=4 * b)]
    rows = sequence_packing.pack(
        [sequence_packing.Request(n, 0.0, 1.0, i)
         for i, n in enumerate(lengths)], s)[:b]
    return sequence_packing.segment_ids(rows)


@pytest.mark.parametrize("b,s,h,kv,d,causal,dtype,segments", [
    (2, 256, 6, 2, 128, True, torch.bfloat16, False),   # minitron's G = 3
    (2, 512, 6, 2, 128, True, torch.bfloat16, True),    # packed rows
    (2, 197, 12, 12, 64, False, torch.bfloat16, False),  # ViT-B/16 tokens
    (1, 255, 4, 1, 32, True, torch.bfloat16, False),    # ragged, causal
    (1, 130, 4, 2, 32, True, torch.float32, False),
    (2, 200, 4, 4, 64, False, torch.float32, True),
])
def test_flash_attention_kernel_against_plain(cuda, b, s, h, kv, d, causal,
                                              dtype, segments):
    """K6 within 2e-2 (bf16) / 1e-4 (f32) of ``mha_reference``: GQA,
    causal and not, ragged lengths, and packed segments whose rows see
    whole 64-position tiles of other requests fully masked."""
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)], dtype,
                   cuda)
    seg = (torch.from_numpy(_packed_segments(rng, b, s)).to(cuda)
           if segments else None)
    before = kernels.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                    impl="torch")
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("pos", [0, 1, 63, 64, 511])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_kernel_against_plain(cuda, pos, dtype):
    """K7 within 2e-2 (bf16) / 1e-4 (f32) of ``decode_reference`` over a
    512-position cache, positions around the tile edges."""
    rng = np.random.default_rng(15)
    b, h, kv, d, smax = 2, 6, 2, 128, 512
    q, k, v = _qkv(rng, [(b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d)],
                   dtype, cuda)
    before = kernels.LAUNCHES["flash_decode"]
    got = attn_ops.flash_decode(q, k, v, pos)
    assert kernels.LAUNCHES["flash_decode"] == before + 1
    want = attn_ops.flash_decode(q, k, v, pos, impl="torch")
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


K7_ROW_TOL = 0.077     # chip_smoke.ATTN_ROW_TOL["k7", bf16]


def _k7_against_plain(q, k, v, pos):
    """K7 launched at the host int ``pos`` and at ``pos`` as a 0-d int32
    on the card: the two bit-equal, and against ``decode_reference``
    within ATTN_TOL, every output row within K7_ROW_TOL (bf16) of its own
    RMS."""
    before = kernels.LAUNCHES["flash_decode"]
    got = attn_ops.flash_decode(q, k, v, pos)
    on_card = attn_ops.flash_decode(
        q, k, v, torch.tensor(pos, dtype=torch.int32, device=q.device))
    assert kernels.LAUNCHES["flash_decode"] == before + 2
    assert torch.equal(on_card, got)
    want = attn_ops.flash_decode(q, k, v, pos, impl="torch")
    assert got.dtype == q.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    tol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if q.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        err = (g - w).abs().amax(-1)
        rms = w.square().mean(-1).sqrt().clamp_min(1e-30)
        assert float((err / rms).max()) <= K7_ROW_TOL


@pytest.mark.parametrize("b,smax,h,kv,d,pos,chunks", [
    (2, 4096, 24, 8, 128, 0, 1),       # one position, one chunk a pair
    (2, 4096, 24, 8, 128, 63, 1),      # one block pass, ragged
    (2, 4096, 24, 8, 128, 64, 2),
    (2, 4096, 24, 8, 128, 511, 8),     # the most chunks a pair
    (2, 4096, 24, 8, 128, 512, 5),     # 9 passes: 5 chunks of 2
    (2, 4096, 24, 8, 128, 4095, 8),    # the cache's last position
    (1, 1000, 8, 8, 32, 999, 8),       # G = 1, D = 32
    (3, 2048, 64, 8, 64, 1500, 5),     # G = 8, D = 64
    (1, 300, 48, 2, 128, 257, 5),      # G = 24: two head groups
    (64, 512, 24, 8, 128, 511, 1),     # more pairs than SMs: one chunk
])
def test_flash_decode_cluster_edges_against_plain(cuda, b, smax, h, kv, d,
                                                  pos, chunks):
    """The bf16 K7 (one cluster of chunks a KV head) within 2e-2 and the
    row limit of ``decode_reference`` at chunk and tile edges, G 1 to 24,
    D 32 to 128, one live chunk a pair to eight; at a device pos
    bit-equal to the host int."""
    plan = flash_kernels.decode_plan(
        b, smax, h, kv, d, torch.bfloat16,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert pos // flash_kernels.decode_chunk(pos, plan.grid[0]) + 1 == chunks
    rng = np.random.default_rng(19)
    q, k, v = _qkv(rng, [(b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d)],
                   torch.bfloat16, cuda)
    _k7_against_plain(q, k, v, pos)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_decode_float32_against_plain(cuda, d):
    """The float32 K7 (CUDA cores, the same ring and merge) within 1e-4,
    G = 3 and G = 20 (two head groups)."""
    rng = np.random.default_rng(20)
    for h, kv, pos in ((6, 2, 700), (20, 1, 130)):
        q, k, v = _qkv(rng, [(2, 1, h, d), (2, 1024, kv, d),
                             (2, 1024, kv, d)], torch.float32, cuda)
        _k7_against_plain(q, k, v, pos)


def test_flash_decode_back_to_back_positions(cuda):
    """Calls back to back on one cache at positions that change the live
    chunks (1 to 8 and back), as a decode run makes them, at host ints
    and at one device pos written between launches: nothing a call
    leaves behind reaches the next."""
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, [(2, 1, 24, 128), (2, 4096, 8, 128),
                         (2, 4096, 8, 128)], torch.bfloat16, cuda)
    order = (4095, 0, 300, 64, 4095, 1, 2047)
    outs = [attn_ops.flash_decode(q, k, v, pos) for pos in order]
    dev = torch.zeros((), dtype=torch.int32, device=cuda)
    on_card = []
    for pos in order:
        dev.fill_(pos)
        on_card.append(attn_ops.flash_decode(q, k, v, dev))
    for pos, got, got_dev in zip(order, outs, on_card):
        want = attn_ops.flash_decode(q, k, v, pos, impl="torch")
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert torch.equal(got_dev, got)


@pytest.mark.parametrize("b,smax,pos", [
    (2, 4096, 0), (2, 4096, 63), (2, 4096, 64), (2, 4096, 287),
    (2, 4096, 4095),
    (2, 32768, 5),         # far below Smax: 7 empty blocks a cluster
    (8, 32768, 20000),     # the slice's 2 chunks, the second live
])
def test_flash_decode_device_pos_equals_host_int(cuda, b, smax, pos):
    """K7 with ``pos`` a 0-d int32 on the card (the grid and cluster fixed
    by Smax, each block reading pos) bit-equal to the host-int launch and
    within its limits of the plain version, at minitron-4b's heads; a
    device pos past the cache reads as Smax - 1 (the kernel clamps)."""
    rng = np.random.default_rng(22)
    q, k, v = _qkv(rng, [(b, 1, 24, 128), (b, smax, 8, 128),
                         (b, smax, 8, 128)], torch.bfloat16, cuda)
    _k7_against_plain(q, k, v, pos)
    if pos == smax - 1:
        past = torch.tensor(smax + 9, dtype=torch.int32, device=cuda)
        assert torch.equal(attn_ops.flash_decode(q, k, v, past),
                           attn_ops.flash_decode(q, k, v, pos))


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    kv3 = torch.zeros((1, 64, 3, 64), device=cuda, dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    bad = [
        ((q.half(), kv.half(), kv.half()), {}, "dtype"),
        ((q, kv.float(), kv), {}, "is torch.float32"),
        ((q, kv3, kv3), {}, "multiple"),
        ((q[..., :44].contiguous(), kv[..., :44].contiguous(),
          kv[..., :44].contiguous()), {}, "head dim"),
        ((q.transpose(1, 2), kv, kv), {}, "contiguous"),
        ((q, kv[:, :32].contiguous(), kv[:, :32].contiguous()),
         {"causal": True}, "Sq == Skv"),
        ((q, kv, kv), {"segment_ids": torch.zeros((1, 64), device=cuda)},
         "segment_ids"),
        ((q, kv.cpu(), kv), {}, "expected"),
    ]
    for args, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            attn_ops.flash_attention(*args, **kw)
    q1 = q[:, :1].contiguous()
    for pos, match in ((64, "pos"), (-1, "pos"),
                       (torch.tensor(3, device=cuda), "0-d int32"),
                       (torch.tensor(3, dtype=torch.int32), "0-d int32"),
                       (torch.tensor([3], dtype=torch.int32, device=cuda),
                        "0-d int32")):
        with pytest.raises(ValueError, match=match):
            attn_ops.flash_decode(q1, kv, kv, pos)
    with pytest.raises(ValueError, match=r"\(B, 1, H, D\)"):
        attn_ops.flash_decode(q[:, :2].contiguous(), kv, kv, 3)
    # K7 keeps its three head dims where K6 takes every multiple of 8
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_decode(q1[..., :48].contiguous(),
                              kv[..., :48].contiguous(),
                              kv[..., :48].contiguous(), 3)
    assert kernels.LAUNCHES == before     # nothing launched, no fallback


def test_lm_prefill_and_decode_on_card_run_k6_and_k7(cuda):
    """The reduced minitron-4b on the card: prefill launches K6 once a
    layer, each decode step K7 once a layer, the plain run neither; the
    kernel and plain logits agree, and decode logits equal prefill logits
    position by position."""
    cfg = reduce_arch(get("minitron-4b"))
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tok = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, size=(2, 96))).to(cuda)
    before = dict(kernels.LAUNCHES)
    h, _ = transformer.forward(cfg, params, tok)
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + cfg.n_layers)
    h_plain, _ = transformer.forward(cfg, params, tok, impl="torch")
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + cfg.n_layers)
    torch.testing.assert_close(h, h_plain, atol=1e-4, rtol=1e-4)
    want = transformer.logits(cfg, params, h)
    cache = transformer.init_cache(cfg, 2, 128, cuda)
    for pos in range(8):
        got, cache = transformer.decode_step(cfg, params,
                                             tok[:, pos:pos + 1], cache, pos)
        torch.testing.assert_close(got[:, 0], want[:, pos], atol=1e-4,
                                   rtol=1e-4)
    assert kernels.LAUNCHES["flash_decode"] == (
        before["flash_decode"] + 8 * cfg.n_layers)


def test_int8_lm_on_card_runs_k6_and_k7(cuda):
    """The reduced minitron-4b with int8 weights and an int8 KV cache on
    the card: K6 in prefill and K7 in decode over the dequantized cache,
    kernel logits against plain, and the int8 model tracking the fp one
    (tests/test_quantize.py's correlations)."""
    cfg = reduce_arch(get("minitron-4b"))
    qcfg = dataclasses.replace(cfg, quant_weights=True, quant_kv=True)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    qparams = quantize_params(transformer.param_specs(qcfg), params)
    tok = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab, size=(2, 64))).to(cuda)
    before = dict(kernels.LAUNCHES)
    last, _ = transformer.prefill(qcfg, qparams, tok)
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + cfg.n_layers)
    last_plain, _ = transformer.prefill(qcfg, qparams, tok, impl="torch")
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + cfg.n_layers)
    torch.testing.assert_close(last, last_plain, atol=1e-4, rtol=1e-4)
    fp_last, _ = transformer.prefill(cfg, params, tok, impl="torch")
    corr = lambda a, b: float(np.corrcoef(a.float().cpu().numpy().ravel(),
                                          b.float().cpu().numpy().ravel())
                              [0, 1])
    assert corr(last, fp_last) > 0.99
    caches = [transformer.init_cache(c, 2, 128, cuda)
              for c in (qcfg, qcfg, cfg)]
    assert caches[0]["layer_0"]["k"].dtype == torch.int8
    before = dict(kernels.LAUNCHES)
    for pos in range(8):
        t = tok[:, pos:pos + 1]
        got, _ = transformer.decode_step(qcfg, qparams, t, caches[0], pos)
        plain, _ = transformer.decode_step(qcfg, qparams, t, caches[1], pos,
                                           impl="torch")
        fp, _ = transformer.decode_step(cfg, params, t, caches[2], pos,
                                        impl="torch")
        torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
    assert corr(got, fp) > 0.99
    # layer 0's new K rows do not depend on attention: the same bits
    assert torch.equal(caches[0]["layer_0"]["k"], caches[1]["layer_0"]["k"])
    assert kernels.LAUNCHES["flash_decode"] == (
        before["flash_decode"] + 8 * cfg.n_layers)


# ------------------------------------------- K4 / K6 wgmma kernels' edges ----

def _scattered_records(rng, b, m, n, cell=(53, 47)):
    """Records for ``b`` canvases of m x n: one placement per cell of a
    53 x 47 px grid, at a random offset and size inside it, so edges fall
    inside tokens at offsets that are no multiple of 4 or 8, some token row
    segments lie whole in a placement and some canvases hold a placement at
    (0, 0) wider than a token.  Returns (records (b, K, 6), (P, hmax, wmax))
    with every slot of its own."""
    ch, cw = cell
    rows = []
    slot = 0
    hmax = wmax = 1
    for bi in range(b):
        recs = []
        for y0 in range(0, m - 8, ch):
            for x0 in range(0, n - 8, cw):
                if rng.random() < 0.2:
                    continue            # some cells stay empty
                h = int(rng.integers(1, min(ch, m - y0) + 1))
                w = int(rng.integers(1, min(cw, n - x0) + 1))
                y = y0 + int(rng.integers(0, min(ch, m - y0) - h + 1))
                x = x0 + int(rng.integers(0, min(cw, n - x0) - w + 1))
                if bi % 2 == 0 and y0 == 0 and x0 == 0:
                    y, x, h, w = 0, 0, min(ch, m), min(cw, n)
                recs.append((1, slot, x, y, w, h))
                hmax, wmax = max(hmax, h), max(wmax, w)
                slot += 1
        rows.append(recs)
    k = max(1, max(len(r) for r in rows))
    records = np.zeros((b, k, 6), np.int32)
    for bi, recs in enumerate(rows):
        if recs:
            records[bi, :len(recs)] = recs
    return records, (max(slot, 1), hmax, wmax)


@pytest.mark.parametrize("b,m,n", [(1, 256, 320), (3, 256, 256),
                                   (4, 96, 160), (3, 96, 160)])
def test_stitch_embed_wgmma_edges_against_plain(cuda, b, m, n):
    """The bf16 K4 kernel within 2e-2 of its plain version where its
    segment table and tiling are at risk: placement edges inside a token's
    32-pixel rows at offsets no multiple of 4 or 8, whole, empty and cut
    row segments, and canvases whose token count (15 at 96 x 160) is no
    multiple of the 128-token tile, at B = 1, 3 and 4 and d = 768 (four
    192-column tiles)."""
    patch, d = 32, 768
    rng = np.random.default_rng(17)
    records, (p, hmax, wmax) = _scattered_records(rng, b, m, n)
    slots = torch.from_numpy(rng.normal(size=(p, hmax, wmax, 3)).astype(
        np.float32)).to(cuda)
    rec = torch.from_numpy(records).to(cuda)
    kernel = torch.from_numpy(
        rng.normal(size=(patch * patch * 3, d)).astype(np.float32)
        / np.sqrt(patch * patch * 3)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    before = kernels.LAUNCHES["stitch_embed"]
    got = ops.stitch_embed(slots, rec, kernel, bias, m, n, patch)
    assert kernels.LAUNCHES["stitch_embed"] == before + 1
    want = ops.stitch_embed(slots, rec, kernel, bias, m, n, patch,
                            impl="torch")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("tile", fused_embed.K4_TILES[1:])
@pytest.mark.parametrize("b,m,n,d", [(3, 256, 320, 768), (4, 96, 160, 768),
                                     (3, 256, 256, 384), (2, 256, 256, 512)])
def test_stitch_embed_wgmma_tiles_against_plain_and_default(cuda, tile, b,
                                                            m, n, d):
    """Every other tile of ``K4_TILES`` within K4's 2e-2 of the plain
    version and bit for bit the default tile's output (the tile moves the
    columns a block owns, not the K order of any sum), at the edge cases
    above and at the registry's widths d 768 / 384 / 512."""
    patch = 32
    rng = np.random.default_rng(18)
    records, (p, hmax, wmax) = _scattered_records(rng, b, m, n)
    slots = torch.from_numpy(rng.normal(size=(p, hmax, wmax, 3)).astype(
        np.float32)).to(cuda)
    rec = torch.from_numpy(records).to(cuda)
    kernel = torch.from_numpy(
        rng.normal(size=(patch * patch * 3, d)).astype(np.float32)
        / np.sqrt(patch * patch * 3)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    default = ops.stitch_embed(slots, rec, kernel, bias, m, n, patch)
    before = kernels.LAUNCHES["stitch_embed"]
    got = ops.stitch_embed(slots, rec, kernel, bias, m, n, patch, tile=tile)
    assert kernels.LAUNCHES["stitch_embed"] == before + 1
    want = ops.stitch_embed(slots, rec, kernel, bias, m, n, patch,
                            impl="torch")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(got, default)


def test_decode_step_captured_once_replays_every_position(cuda):
    """The reduced minitron-4b on the card: one decode step captured in a
    CUDA graph on static tokens, ``pos`` (a 0-d int32) and the in-place
    cache, replayed at positions 0..7 with the next token and pos + 1
    written between replays: each replay's logits and the cache bit-equal
    to the eager step at the host int on a second cache.  Capture
    launches K7 once a layer (the host counter), a replay moves no
    counter."""
    cfg = reduce_arch(get("minitron-4b"))
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    cache = transformer.init_cache(cfg, 2, 128, cuda)
    eager = transformer.init_cache(cfg, 2, 128, cuda)
    tok = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, size=(2, 1))).to(cuda)
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up (writes row 0, replayed)
        transformer.decode_step(cfg, params, tok, cache, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        logits, out = transformer.decode_step(cfg, params, tok, cache, pos)
    assert out is cache
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert launched == {k: cfg.n_layers if k == "flash_decode" else 0
                        for k in before}
    for step in range(8):
        want, eager = transformer.decode_step(cfg, params, tok, eager, step)
        counts = dict(kernels.LAUNCHES)
        graph.replay()
        assert kernels.LAUNCHES == counts
        assert torch.equal(logits, want), step
        tok.copy_(logits[:, 0].float().argmax(-1, keepdim=True))
        pos.add_(1)
    for name, layer in cache.items():
        for key, leaf in layer.items():
            assert torch.equal(leaf, eager[name][key])
    assert int(pos) == 8 and not cache["layer_0"]["k"][:, 8:].any()


def test_masked_decode_on_card_equals_in_place(cuda):
    """The reduced minitron-4b on the card, 8 decode steps through K7 with
    ``cache_update="masked"`` and with ``"dus"``: logits and caches
    bit-equal (K7 sees the same cache), the masked run's input caches
    untouched, K7 once a layer a step in each."""
    cfg = reduce_arch(get("minitron-4b"))
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, size=(2, 8))).to(cuda)
    caches = {u: transformer.init_cache(cfg, 2, 128, cuda)
              for u in ("dus", "masked")}
    before = kernels.LAUNCHES["flash_decode"]
    for pos in range(8):
        out = {}
        for u in ("dus", "masked"):
            c = dataclasses.replace(cfg, cache_update=u)
            old = {k: v.clone() for k, v in caches[u]["layer_0"].items()}
            out[u], new = transformer.decode_step(c, params,
                                                  tok[:, pos:pos + 1],
                                                  caches[u], pos)
            if u == "masked":
                for k, v in caches[u]["layer_0"].items():
                    assert torch.equal(v, old[k])
            caches[u] = new
        assert torch.equal(out["dus"], out["masked"])
    assert kernels.LAUNCHES["flash_decode"] == before + 2 * 8 * cfg.n_layers
    for name, layer in caches["dus"].items():
        for k, v in layer.items():
            assert torch.equal(v, caches["masked"][name][k])


def test_stitch_embed_wgmma_wrapper_rejects_what_it_does_not_take(cuda):
    """Shapes the bf16 K4 kernel does not take raise before any launch:
    K = patch^2 * C not in steps of 64, d not a multiple of 8, weights off
    16-byte alignment."""
    slots = torch.zeros((2, 8, 8, 3), device=cuda)
    rec = torch.zeros((1, 2, 6), dtype=torch.int32, device=cuda)
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    cases = [
        ((slots, rec, torch.zeros((4 * 4 * 3, 16), device=cuda, dtype=bf),
          torch.zeros((16,), device=cuda, dtype=bf), 64, 64, 4),
         "steps of 64"),
        ((slots, rec, torch.zeros((32 * 32 * 3, 12), device=cuda, dtype=bf),
          torch.zeros((12,), device=cuda, dtype=bf), 64, 64, 32),
         "multiple of 8"),
        ((slots, rec, torch.zeros(32 * 32 * 3 * 16 + 1, device=cuda,
                                  dtype=bf)[1:].view(32 * 32 * 3, 16),
          torch.zeros((16,), device=cuda, dtype=bf), 64, 64, 32),
         "aligned"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            ops.stitch_embed(*args, impl="cuda")
    assert kernels.LAUNCHES == before


def _block_segments(rng, b, s):
    """Sorted random segment ids: contiguous requests of any length >= 1."""
    return np.sort(rng.integers(0, max(1, s // 24) + 1, size=(b, s)),
                   axis=1).astype(np.int32)


K6_SEQS = [1, 63, 64, 65, 127, 129, 197, 4095]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", K6_SEQS)
def test_flash_attention_wgmma_edges_against_plain(cuda, s, d):
    """The bf16 K6 kernel within 2e-2 of ``mha_reference`` around its
    128-row query and 128-position KV tiles (S from 1 to 4095, ragged and
    exact), at D = 32, 64 and 128, G = 1 and 3, causal, non-causal and
    with packed segment ids (the mode and G turn with S)."""
    i = K6_SEQS.index(s)
    mode = ("causal", "plain", "segments")[(i + d // 32) % 3]
    kv = 2 if s < 4095 else 1
    g = (1, 3)[i % 2]
    b = 2 if s < 4095 else 1
    rng = np.random.default_rng(18 + i)
    q, k, v = _qkv(rng, [(b, s, kv * g, d), (b, s, kv, d), (b, s, kv, d)],
                   torch.bfloat16, cuda)
    seg = (torch.from_numpy(_block_segments(rng, b, s)).to(cuda)
           if mode == "segments" else None)
    causal = mode != "plain"
    before = kernels.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                    impl="torch")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


K6_OTHER_SEQS = [1, 63, 64, 65, 197, 1024, 1025]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 72, 80, 96])
@pytest.mark.parametrize("s", K6_OTHER_SEQS)
def test_flash_attention_other_head_dims_against_plain(cuda, s, d, dtype):
    """K6 at head dims outside 32 / 64 / 128 (the reduced configs' 16,
    DiT-XL/2's 72, and 80 / 96), bf16 on the wgmma kernel's padded
    layout within 2e-2 and float32 on the FMA kernel within 1e-4 of
    ``mha_reference``: S from 1 to 1025, causal, non-causal and with
    packed segment ids (the mode and G turn with S)."""
    i = K6_OTHER_SEQS.index(s)
    mode = ("plain", "causal", "segments")[(i + d // 8) % 3]
    g = (1, 3)[i % 2]
    rng = np.random.default_rng(40 + i)
    q, k, v = _qkv(rng, [(2, s, 2 * g, d), (2, s, 2, d), (2, s, 2, d)],
                   dtype, cuda)
    seg = (torch.from_numpy(_block_segments(rng, 2, s)).to(cuda)
           if mode == "segments" else None)
    causal = mode != "plain"
    before = kernels.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attn_ops.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                                    impl="torch")
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("d", flash_kernels.HEAD_DIMS)
def test_flash_attention_every_bf16_head_dim_on_wgmma(cuda, d):
    """bf16 K6 at every head dim it takes (multiples of 8 up to 128) runs
    the wgmma kernel, within 2e-2 of ``mha_reference``: S = 255 (a full
    and a ragged 128-row tile), G = 2, causal with packed segment ids,
    then non-causal over a longer KV (S = 129 queries, 383 positions)."""
    assert flash_kernels.k6_kernel(torch.bfloat16, d) == "wgmma"
    rng = np.random.default_rng(300 + d)
    q, k, v = _qkv(rng, [(2, 255, 4, d), (2, 255, 2, d), (2, 255, 2, d)],
                   torch.bfloat16, cuda)
    seg = torch.from_numpy(_block_segments(rng, 2, 255)).to(cuda)
    cases = [(q, k, v, True, seg)]
    q, k, v = _qkv(rng, [(1, 129, 2, d), (1, 383, 2, d), (1, 383, 2, d)],
                   torch.bfloat16, cuda)
    cases.append((q, k, v, False, None))
    for q, k, v, causal, seg in cases:
        before = kernels.LAUNCHES["flash_attention"]
        got = attn_ops.flash_attention(q, k, v, causal=causal,
                                       segment_ids=seg)
        assert kernels.LAUNCHES["flash_attention"] == before + 1
        want = attn_ops.flash_attention(q, k, v, causal=causal,
                                        segment_ids=seg, impl="torch")
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def test_flash_attention_dit_xl2_gen_1024_shape_against_plain(cuda):
    """K6 at one DiT-XL/2 layer of gen_1024 (B=4, 4,096 latent tokens, 16
    heads of 72 on the wgmma kernel's layout padded to 80, non-causal),
    bf16 within 2e-2 of its plain version."""
    assert flash_kernels.k6_kernel(torch.bfloat16, 72) == "wgmma"
    rng = np.random.default_rng(48)
    q, k, v = _qkv(rng, [(4, 4096, 16, 72)] * 3, torch.bfloat16, cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(q, k, v, causal=False)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attn_ops.flash_attention(q, k, v, causal=False, impl="torch")
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_dit_xl2_shape_against_plain(cuda):
    """K6 at one DiT-XL/2 layer of gen_fast (B=16, 1,024 latent tokens, 16
    heads of 72, non-causal), bf16 within 2e-2."""
    rng = np.random.default_rng(47)
    q, k, v = _qkv(rng, [(16, 1024, 16, 72)] * 3, torch.bfloat16, cuda)
    got = attn_ops.flash_attention(q, k, v, causal=False)
    want = attn_ops.flash_attention(q, k, v, causal=False, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_deepseek_moe_shape_against_plain(cuda):
    """K6 at one deepseek-moe-16b prefill layer (B=2, S=4096, 16 query
    heads over 16 KV heads, G = 1, D 128, causal: the wgmma kernel),
    bf16 within 2e-2 of its plain version."""
    rng = np.random.default_rng(49)
    q, k, v = _qkv(rng, [(2, 4096, 16, 128)] * 3, torch.bfloat16, cuda)
    before = kernels.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(q, k, v, causal=True)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = attn_ops.flash_attention(q, k, v, causal=True, impl="torch")
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("pos", [0, 63, 511, 4095])
def test_flash_decode_deepseek_moe_shape_against_plain(cuda, pos):
    """K7 at deepseek-moe-16b's decode shape (B=2, a 4,096-position
    cache, 16 query heads over 16 KV heads, G = 1, D 128) within 2e-2 and
    the row limit of its plain version."""
    rng = np.random.default_rng(50 + pos)
    q, k, v = _qkv(rng, [(2, 1, 16, 128), (2, 4096, 16, 128),
                         (2, 4096, 16, 128)], torch.bfloat16, cuda)
    _k7_against_plain(q, k, v, pos)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-scout-17b-a16e"])
def test_moe_lm_on_card_matches_cpu(cuda, arch):
    """The reduced MoE LMs (float32) on the card against the same weights
    on the CPU: prefill hidden states, logits and aux loss, then eight
    decode steps (groups of two tokens at capacity 1), within 1e-4; K6
    once a layer in prefill and K7 once a layer a step."""
    cfg = reduce_arch(get(arch))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    dev = map_tree(lambda t: t.to(cuda), params)
    tok = torch.from_numpy(np.random.default_rng(51).integers(
        0, cfg.vocab, size=(2, 128)))
    before = dict(kernels.LAUNCHES)
    h, aux = transformer.forward(cfg, dev, tok.to(cuda))
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + cfg.n_layers)
    h_cpu, aux_cpu = transformer.forward(cfg, params, tok)
    torch.testing.assert_close(h.cpu(), h_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-5, rtol=1e-5)
    caches = (transformer.init_cache(cfg, 2, 16, cuda),
              transformer.init_cache(cfg, 2, 16, "cpu"))
    for pos in range(8):
        t = tok[:, pos:pos + 1]
        got, _ = transformer.decode_step(cfg, dev, t.to(cuda), caches[0],
                                         pos)
        want, _ = transformer.decode_step(cfg, params, t, caches[1], pos)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert kernels.LAUNCHES["flash_decode"] == (
        before["flash_decode"] + 8 * cfg.n_layers)


@pytest.mark.parametrize("arch", ["vit-b16", "deit-b", "dit-xl2"])
def test_zoo_on_card_runs_k6_once_a_layer(cuda, arch):
    """The reduced classifiers and DiT on the card in bf16 (heads of 16):
    ``impl="flash"`` launches K6 once a layer and agrees with K6's plain
    version within 2e-2; ``impl="torch"`` and the default launch none."""
    from repro_torch.models import dit, vit
    cfg = dataclasses.replace(reduce_arch(get(arch)),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    rng = np.random.default_rng(48)
    if arch.startswith("dit"):
        params = dit.init_params(cfg, gen, cuda)
        for lp in params["layers"]:     # adaLN-zero would zero the output
            lp["ada"]["kernel"].normal_(0.0, 0.02, generator=gen)
        params["final_proj"]["kernel"].normal_(0.0, 0.02, generator=gen)
        z = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(
            np.float32)).to(cuda)
        t = torch.tensor([999, 10], device=cuda)
        labels = torch.tensor([1, 2], device=cuda)

        def run(impl):
            return dit.forward(cfg, params, z, t, labels, impl=impl)
    else:
        params = vit.init_params(cfg, gen, cuda)
        x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(
            np.float32)).to(cuda)

        def run(impl):
            return vit.forward(cfg, params, x, impl=impl)[0]
    before = kernels.LAUNCHES["flash_attention"]
    got = run("flash")
    assert kernels.LAUNCHES["flash_attention"] == before + cfg.n_layers
    want = run("torch")
    run("xla")
    assert kernels.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert float(want.float().abs().max()) > 0
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------- K1 / K3 edge cases ----

#: K1 edge cases: (B, M, N, K, hmax, wmax, P).  "odd-rows": 45-pixel canvas
#: rows, never a multiple of 16 bytes; "row-tiles": the main path's canvases,
#: 4 rows a block, placements starting and ending inside row tiles;
#: "overlap": placements overlapping at random; "2048-records": the most
#: records a canvas may hold, on one canvas, overlapping.
K1_CASES = {"odd-rows": (2, 37, 45, 12, 20, 24, 6),
            "row-tiles": (3, 1024, 1024, 64, 256, 512, 40),
            "overlap": (2, 256, 256, 64, 128, 128, 16),
            "2048-records": (1, 1024, 1024, 2048, 64, 64, 32)}


def _random_records(rng, b, k, m, n, hmax, wmax, p, valid=0.85):
    """Placements at random inside the canvas (overlapping, edges at any
    offset), slots drawn with repeats below ``p``, some records invalid."""
    w = rng.integers(1, wmax + 1, size=(b, k))
    h = rng.integers(1, hmax + 1, size=(b, k))
    x = rng.integers(0, n - w + 1)
    y = rng.integers(0, m - h + 1)
    ok = (rng.random((b, k)) < valid).astype(np.int64)
    slot = rng.integers(0, p, size=(b, k))
    return np.stack([ok, slot, x, y, w, h], -1).astype(np.int32)


def _k1_case(kind, c, dtype, device, seed=31):
    rng = np.random.default_rng(seed)
    b, m, n, k, hmax, wmax, p = K1_CASES[kind]
    records = _random_records(rng, b, k, m, n, hmax, wmax, p)
    if dtype.is_floating_point:
        host = rng.normal(size=(p, hmax, wmax, c))
    else:
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        host = rng.integers(lo, hi, size=(p, hmax, wmax, c))
    slots = torch.from_numpy(host.astype(np.float32)).to(device, dtype)
    return slots, torch.from_numpy(records).to(device), m, n


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("kind", list(K1_CASES))
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stitch_kernel_edges_bit_exact(cuda, dtype, c, kind):
    """K1 bit-exact against its plain version where its plan and owner map
    are at risk: narrower stores, tile edges, overlaps (the last record in
    k order wins) and 2,048 records a canvas."""
    slots, rec, m, n = _k1_case(kind, c, DTYPES[dtype], cuda)
    rows = kernels.stitch_plan(rec.shape[0], m, n, c,
                               slots.element_size())[0]
    assert rows > 1 or kind != "row-tiles"
    before = kernels.LAUNCHES["stitch"]
    got = ops.stitch_canvases(slots, rec, m, n)
    assert kernels.LAUNCHES["stitch"] == before + 1
    want = ops.stitch_canvases(slots, rec, m, n, impl="torch")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("kind", ["odd-rows", "overlap", "row-tiles"])
@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_stitch_entry_writes_every_byte(cuda, dtype, kind):
    """``tangram_stitch`` called directly on an output filled with 0xFF
    bytes, from the wrapper's plan: equal to the plain version, so the
    kernel wrote every byte."""
    slots, rec, m, n = _k1_case(kind, 3, DTYPES[dtype], cuda)
    p, hmax, wmax, c = slots.shape
    b, k, _ = rec.shape
    out = torch.empty((b, m, n, c), dtype=slots.dtype, device=cuda)
    _bytes(out).fill_(0xFF)
    plan = kernels.stitch_plan(b, m, n, c, slots.element_size())
    rc = kernels.library().tangram_stitch(
        slots.data_ptr(), rec.data_ptr(), out.data_ptr(), hmax, wmax, c, b,
        k, m, n, slots.element_size(), *plan,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    want = ops.stitch_canvases(slots, rec, m, n, impl="torch")
    assert torch.equal(_bytes(out), _bytes(want))


def _k3_case(side, dtype, device, seed=41, patch=32):
    """Raw heads and records for K3 (patch 32 unless given): slots named
    twice (within a canvas and across canvases), the last ten slots never
    named, placement edges at any pixel offset, and a third of the centre
    logits at +-30 (saturated sigmoid: decoded centres on cell edges)."""
    rng = np.random.default_rng(seed)
    b, k, cap = 3, 64, 120
    m = side * patch
    records = _random_records(rng, b, k, m, m, m // 2, m // 2, cap - 10)
    raw = rng.normal(size=(b, side, side, 5)).astype(np.float32)
    sat = rng.random((b, side, side, 2)) < 1 / 3
    raw[..., 1:3] = np.where(sat, rng.choice([-30.0, 30.0], sat.shape),
                             raw[..., 1:3])
    named = records[..., 1][records[..., 0] > 0]
    assert len(named) > len(set(named.tolist()))      # some slot twice
    return (torch.from_numpy(raw).to(device, dtype),
            torch.from_numpy(records).to(device), patch, cap)


@pytest.mark.parametrize("side", [32, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_duplicates_unnamed_saturated(cuda, dtype, side):
    """K3 against its plain version: equal hit masks and values within
    1e-5, the last valid record naming a slot wins, unnamed slots are
    zero; side 33 (1,089 cells a canvas) takes the scalar stores."""
    raw, rec, patch, cap = _k3_case(side, DTYPES[dtype], cuda)
    before = kernels.LAUNCHES["unstitch_decode"]
    got = ops.unstitch_decode(raw, rec, patch, cap)
    assert kernels.LAUNCHES["unstitch_decode"] == before + 1
    want = ops.unstitch_decode(raw, rec, patch, cap, impl="torch")
    assert torch.equal(got[..., 0] > 0, want[..., 0] > 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[cap - 10:].any() and (got[..., 0] > 0).any()


@pytest.mark.parametrize("side", [32, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_entry_writes_every_byte(cuda, dtype, side):
    """``tangram_unstitch_decode`` called directly on an output filled
    with 0xFF bytes (NaN as float32): finite and within 1e-5 of the plain
    version everywhere, so the kernel wrote every byte."""
    raw, rec, patch, cap = _k3_case(side, DTYPES[dtype], cuda)
    b, k, _ = rec.shape
    out = torch.empty((cap, side, side, 5), device=cuda)
    _bytes(out).fill_(0xFF)
    rc = fused_embed.library().tangram_unstitch_decode(
        raw.data_ptr(), rec.data_ptr(), out.data_ptr(), b, k, side, side,
        cap, patch, int(raw.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    want = ops.unstitch_decode(raw, rec, patch, cap, impl="torch")
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


# ---------------------------------- the registry detectors' widths ----

@pytest.mark.parametrize("kind", ["random", "flush", "many"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("patch,d", [(16, 384), (32, 512)])
def test_fused_kernels_at_registry_widths(cuda, patch, d, dtype, tol, kind):
    """K4 and K3 at ``vit_s16``'s shape (patch 16: K = 768, d 384, 4,096
    tokens and a 64x64 head grid a canvas) and ``efficientnet_b7``'s (patch
    32, d 512: a last column tile of 128), on packer plans and on about
    1,700 scattered records a canvas, against their plain versions with the
    tolerances of ``test_fused_kernels_against_plain``."""
    m = 1024
    rng = np.random.default_rng(13)
    if kind == "many":
        # one placement a 22 x 22 px cell: about 1,700 records a canvas
        b = 2
        records, (cap, hmax, wmax) = _scattered_records(rng, b, m, m,
                                                        cell=(22, 22))
        assert 1500 < records.shape[1] <= 2048
        slots = torch.from_numpy(rng.normal(
            size=(cap, hmax, wmax, 3)).astype(np.float32)).to(cuda)
    else:
        plan, patches = _plan(kind, m, rng)
        crops = [rng.normal(size=(p.h, p.w, 3)).astype(np.float32)
                 for p in patches]
        slots = torch.from_numpy(ops.pack_plan_host(crops, plan)).to(cuda)
        records, b, cap = plan.records, plan.num_canvases, plan.slot_capacity
    rec = torch.from_numpy(records).to(cuda)
    wdt = DTYPES[dtype]
    kernel = torch.from_numpy(
        rng.normal(size=(patch * patch * 3, d)).astype(np.float32)
        / np.sqrt(patch * patch * 3)).to(cuda, wdt)
    bias = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        cuda, wdt)
    before = dict(kernels.LAUNCHES)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = ops.stitch_embed(slots, rec, kernel, bias, m, m, patch)
        want = ops.stitch_embed(slots, rec, kernel, bias, m, m, patch,
                                impl="torch")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    side = m // patch
    assert got.shape == want.shape == (b, side * side, d)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    raw = torch.from_numpy(rng.normal(size=(b, side, side, 5)).astype(
        np.float32)).to(cuda, wdt)
    grids = ops.unstitch_decode(raw, rec, patch, cap)
    plain = ops.unstitch_decode(raw, rec, patch, cap, impl="torch")
    assert torch.equal(grids[..., 0] > 0, plain[..., 0] > 0)
    torch.testing.assert_close(grids, plain, atol=1e-5, rtol=1e-5)
    assert kernels.LAUNCHES["stitch_embed"] == before["stitch_embed"] + 1
    assert kernels.LAUNCHES["unstitch_decode"] == \
        before["unstitch_decode"] + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_side_64(cuda, dtype):
    """K3 on a 64x64 head grid at patch 16 (``vit_s16``): duplicates,
    unnamed slots and saturated centres as at side 32."""
    raw, rec, patch, cap = _k3_case(64, DTYPES[dtype], cuda, patch=16)
    got = ops.unstitch_decode(raw, rec, patch, cap)
    want = ops.unstitch_decode(raw, rec, patch, cap, impl="torch")
    assert got.shape == (cap, 64, 64, 5)
    assert torch.equal(got[..., 0] > 0, want[..., 0] > 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[cap - 10:].any() and (got[..., 0] > 0).any()


@pytest.mark.parametrize("fuse", [False, True])
def test_two_worker_model_pool_on_card(cuda, fuse):
    """Two async workers on the serve meshes of ``make_worker_meshes(2)``
    (one card: both on it),
    model placement over two reduced registry models (``vit_s16`` at
    patch 16, ``efficientnet_b7`` at 32) on a two-class trace: kernels and
    plain versions route the same detections and evidence, each model's
    invocations launch K1/K2 (or K4/K3), and no frame is held."""
    frames, arrivals = {}, []
    for i, slo in enumerate((0.3, 2.0)):
        src = make_source("synthetic", n_frames=16, canvas=128, slo=slo,
                          scene=i, camera_id=i, device=cuda,
                          frame_sink=lambda f, px, n:
                          frames.__setitem__(f, (px, n)))
        arrivals.extend(src.events(None))
    arrivals.sort(key=lambda a: a.t_arrive)
    names = {0.3: "vit_s16", 2.0: "efficientnet_b7"}
    builds = {n: make_model(n).build(canvas=128, device=cuda)
              for n in names.values()}
    table = LatencyTable({1: (0.02, 0.002), 4: (0.05, 0.004)})
    paths = (("stitch_embed", "unstitch_decode") if fuse
             else ("stitch", "unstitch"))
    outs = []
    for impl in (None, "torch"):
        models = {n: ModelRuntime(fn, pr, 128, 128,
                                  **(fused_fields(c, pr) if fuse else {}))
                  for n, (c, pr, fn) in builds.items()}
        cfg, params, fn = builds["vit_s16"]
        meshes = make_worker_meshes(2)
        pool = device_worker_pool(
            2, lambda i: make_executor(
                "async_device", serve_fn=fn, params=params, canvas_m=128,
                canvas_n=128, device=data_devices(meshes[i])[0],
                mesh=meshes[i], impl=impl, clock=lambda: 0.0,
                models=models,
                **(fused_kwargs(cfg, params) if fuse else {})),
            placement=make_placement("model"))
        assert [w.device for w in pool.workers] == [
            data_devices(m)[0] for m in meshes]
        assert all(w.device.type == "cuda" for w in pool.workers)
        for fid, (px, n) in frames.items():
            pool.add_frame(fid, px, n)
        launched = {}
        routed = {}
        for w in pool.workers:
            launch = w._launch

            def counted(inv, launch=launch):
                before = dict(kernels.LAUNCHES)
                payload = launch(inv)
                row = launched.setdefault(inv.model, {})
                for k in before:
                    row[k] = row.get(k, 0) + kernels.LAUNCHES[k] - before[k]
                return payload
            w._launch = counted
            release = w.on_complete

            def on_complete(comp, release=release):
                routed[id(comp.invocation)] = comp.outputs
                release(comp)
            w.on_complete = on_complete
        engine = ServingEngine(
            InvokerPool(lambda key: SLOAwareInvoker(128, 128, table, 4),
                        classify=slo_class, model_of=names.get), pool)
        engine.run(arrivals)
        assert len(pool.frames) == 0
        assert set(launched) == set(names.values())
        for row in launched.values():
            assert all((row[k] > 0) == (impl is None and k in paths)
                       for k in row), launched
        assert {ws["worker"] for ws in pool.worker_stats()
                if ws["invocations"]} == {0, 1}
        outs.append([routed[id(inv)] for inv in engine.invocations])
    _assert_same_routing(outs, fuse)


@pytest.mark.parametrize("fuse", [False, True])
def test_two_shards_on_two_streams_match_one_sequential_executor(cuda,
                                                                 fuse):
    """Three cameras through ``--shards 2 --parallel``'s objects: two
    shard executors, each on its own CUDA stream, under a
    ``ParallelShardedEngine``.  Each shard's trunk runs on its stream, the
    kernels launch once an invocation, no frame is held, and every
    invocation replayed through one sequential executor (the current
    stream) routes the same detections and evidence, bit for bit."""
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.fleet import fleet_uniform_pool
    from repro_torch.core.workers import share_frame_store
    from repro_torch.launch.serve import shard_stream, sharded_engine

    frames = {}
    src = make_source("synthetic", n_frames=16, canvas=128, slo=0.3,
                      n_cameras=3, device=cuda, frame_sink=lambda f, px, n:
                      frames.__setitem__(f, (px, n)))
    arrivals = list(src.events(None))
    cfg, params, serve_fn = build_detector(128, device=cuda)
    table = LatencyTable({1: (0.02, 0.002), 4: (0.05, 0.004)})
    fused = fused_kwargs(cfg, params) if fuse else {}
    torch.cuda.synchronize()
    streams = [shard_stream(cuda) for _ in range(2)]
    seen, routed = {}, {}

    def on_stream(fn, s):
        def run(p, x):
            seen.setdefault(s, []).append(torch.cuda.current_stream(cuda))
            return fn(p, x)
        return run

    executors = []
    for s, stream in enumerate(streams):
        kw = dict(fused)
        if fuse:
            kw["tokens_fn"] = on_stream(kw["tokens_fn"], s)
        ex = make_executor("device", serve_fn=on_stream(serve_fn, s),
                           params=params, canvas_m=128, canvas_n=128,
                           device=cuda, clock=lambda: 0.0, stream=stream,
                           **kw)
        release = ex.on_complete

        def on_complete(comp, release=release):
            routed[id(comp.invocation)] = comp.outputs
            release(comp)
        ex.on_complete = on_complete
        executors.append(ex)
    share_frame_store(executors)
    for fid, (px, n) in frames.items():
        executors[0].add_frame(fid, px, n)
    config = ServeConfig(max_canvases=4, shards=2, parallel=True)
    engine = sharded_engine(
        config, executors,
        lambda fleet: fleet_uniform_pool(128, 128, table, max_canvases=4),
        make_source("trace", arrivals=arrivals), table)
    before = dict(kernels.LAUNCHES)
    engine.run(arrivals)
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    invs = engine.invocations
    paths = (("stitch_embed", "unstitch_decode") if fuse
             else ("stitch", "unstitch"))
    assert len(engine.outcomes) == len(arrivals)
    assert len(executors[0].frames) == 0
    assert {inv.shard for inv in invs} == {0, 1}
    assert all(launched[k] == (len(invs) if k in paths else 0)
               for k in launched), launched
    for s, stream in enumerate(streams):
        assert seen[s] and all(x == stream for x in seen[s])
    assert streams[0] != streams[1]

    seq = make_executor("device", serve_fn=serve_fn, params=params,
                        canvas_m=128, canvas_n=128, device=cuda,
                        clock=lambda: 0.0, **fused)
    for fid, (px, n) in frames.items():
        seq.add_frame(fid, px, n)
    for inv in invs:
        comp = seq.submit(inv).completion
        (dets_k, px_k), (dets_s, px_s) = routed[id(inv)], comp.outputs
        assert dets_k == dets_s
        assert set(px_k) == set(px_s)
        for fid in px_s:
            for a, b in zip(px_k[fid], px_s[fid]):
                np.testing.assert_array_equal(a, b)
        seq.on_complete(comp)
    assert len(seq.frames) == 0


def test_k6_refuses_inputs_that_require_grad(cuda):
    """K6 has no backward pass: on inputs that require grad the dispatcher
    raises instead of returning an output without a gradient; under
    ``torch.no_grad`` it launches."""
    q = torch.randn(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        attn_ops.flash_attention(q, k, k, causal=True)
    with torch.no_grad():
        assert attn_ops.flash_attention(q, k, k, causal=True).shape == q.shape


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of the reduced detector (canvas 256, float32, B=4
    from the port's loader) on the card and on the CPU, TF32 off: the
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    max-abs, the parameters after AdamW on the CPU's gradients within
    1e-5 (on each side's own gradients AdamW's first step, lr x g / (|g|
    + eps), turns the rounding of elements near eps into differences up
    to lr); no kernel launched."""
    cfg = train_lib.reduced_config(get("tangram-detector"))
    batch = next(loader.detector_batches(cfg.canvas, 4))
    opt_cfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    loss_fn = train_lib.loss_fn(cfg)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        reset_launches()
        for dev in (torch.device("cpu"), cuda):
            params = train_lib.init_params(cfg, 0, torch.device("cpu"))
            params = map_tree(lambda t: t.to(dev), params)
            loss, grads = value_and_grad(loss_fn, params,
                                         train_lib.to_device(batch, dev))
            grads = [g.cpu() for g in sorted_leaves(grads)]
            cpu_grads = out["cpu"][1] if out else grads
            new, _, _ = opt.update(opt_cfg, replace_leaves(params, [
                g.to(dev) for g in cpu_grads]), opt.init(params), params)
            out[dev.type] = (loss.cpu(), grads,
                             [p.cpu() for p in sorted_leaves(new)])
        assert not any(LAUNCHES.values()), LAUNCHES
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    for tol, got, want in [(1e-4, gg, gc), (1e-5, pg, pc)]:
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(
                w.abs().max().clamp(min=1e-30))


def test_data_parallel_split_over_the_card_twice(cuda):
    """The reduced detector (canvas 256, bf16) on a data=2 serve mesh laid
    over the card twice: ``shard_canvases`` splits a 3-canvas batch into
    two padded chunks on the card, and ``serve_sharded``'s objectness
    and boxes equal one call on the whole batch within bf16 rounding
    (the half batch may tile its GEMMs otherwise)."""
    from repro_torch.core.engine import shard_canvases
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import detector
    cfg = dataclasses.replace(reduce_arch(get("tangram-detector")),
                              canvas=256, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = detector.init_params(cfg, torch.Generator().manual_seed(5),
                                  cuda)
    x = torch.rand((3, 256, 256, 3),
                   generator=torch.Generator(device=cuda).manual_seed(5),
                   device=cuda)
    fn = detector.serve_fn(cfg)
    mesh = make_serve_mesh(devices=[cuda, cuda])
    chunks, sharded = shard_canvases(x, mesh)
    assert sharded and [c.shape[0] for c in chunks] == [2, 2]
    assert all(c.device.type == cuda.type for c in chunks)
    rt = ModelRuntime(fn, params, 256, 256, mesh=mesh)
    obj, boxes = rt.serve_sharded(chunks, 3, cuda)
    want_obj, want_boxes = fn(params, x)
    assert obj.shape == want_obj.shape and boxes.device.type == cuda.type
    torch.testing.assert_close(obj.float(), want_obj.float(), rtol=0,
                               atol=2e-2)
    torch.testing.assert_close(boxes.float(), want_boxes.float(), rtol=2e-2,
                               atol=1.0)


def test_dry_run_flops_equal_a_card_run(cuda):
    """The reduced detector's serve step planned and counted on the unit
    mesh (``dryrun.count_metrics``) against ``FlopCounterMode`` over the
    same step on the card: FLOPs and argument bytes equal."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import api
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_unit_mesh
    from repro_torch.sharding import ShardingConfig
    cfg = dataclasses.replace(reduce_arch(get("tangram-detector")),
                              canvas=256, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = ShapeConfig("serve_c4", "serve", img_res=256, global_batch=4)
    mesh = make_unit_mesh()
    plan = api.plan_cell(cfg, shape, mesh, ShardingConfig.make().rules)
    counted = dryrun.count_metrics(plan, mesh)
    gen = torch.Generator(device=cuda).manual_seed(6)
    from repro_torch import param as tparam
    params = tparam.init_params(api.param_specs(cfg), gen, cuda)
    x = torch.rand((4, 256, 256, 3), generator=gen, device=cuda)
    with FlopCounterMode(display=False) as fc:
        plan.step_fn(params, x)
    assert counted["flops"] == fc.get_total_flops() > 0
    assert counted["args"] == hlo_analysis.local_bytes((params, x))


# ------------------------------------------------------------ examples ----

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load_example(name: str):
    """``examples/<name>.py`` as a fresh module (its ``__main__`` block does
    not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_card_runs_k5(cuda, capsys):
    """The example with no argument runs K5 once a frame; its stream equals
    the plain GMM's on the card and the CPU's, patch for patch."""
    mod = load_example("torch_quickstart")
    reset_launches()
    stream, res = mod.main([])
    assert dict(LAUNCHES) == {**{k: 0 for k in LAUNCHES},
                              "gmm_update": mod.FRAMES}
    plain, _ = mod.edge_stream(cuda, gmm_impl="torch")
    cpu, _ = mod.edge_stream("cpu")
    assert stream and stream == plain == cpu
    table = mod.detector_latency_model(mod.CANVAS, mod.CANVAS).build_table(16)
    assert res.summary() == mod.cloud_report(cpu, table).summary()


def _routes(mp: pytest.MonkeyPatch, routed: dict):
    """Record what ``launch/serve.main``'s executors route, per frame, until
    ``mp`` is undone."""
    from repro_torch.launch import serve
    make = serve.make_executor

    def recording(*a, **kw):
        ex = make(*a, **kw)
        release = ex.on_complete

        def on_complete(comp):
            for fid, dets in comp.outputs[0].items():
                routed.setdefault(fid, []).extend(dets)
            release(comp)

        ex.on_complete = on_complete
        return ex
    mp.setattr(serve, "make_executor", recording)


def _served(out: str) -> tuple:
    m = re.search(r"served (\d+) patches in (\d+) invocations.*routed "
                  r"(\d+) detections.*\((\d+) frames still held", out)
    assert m, out
    return tuple(int(x) for x in m.groups())


def test_serve_example_on_card_matches_cpu(cuda, capsys):
    """K5, K1 and K2 on the card serve what the example serves with
    ``--device cpu``: patches, invocations, 0 frames held, and the routed
    detections but for scores within 1e-3 of 0.5 (float32 summation
    order; scores within 1e-4, boxes within 1e-3 px)."""
    mod = load_example("torch_serve_e2e")
    card, cpu = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _routes(mp, card)
        reset_launches()
        mod.main([])
        launches = dict(LAUNCHES)
    got = _served(capsys.readouterr().out)
    with pytest.MonkeyPatch.context() as mp:
        _routes(mp, cpu)
        mod.main(["--device", "cpu"])
    want = _served(capsys.readouterr().out)
    assert launches["stitch"] == launches["unstitch"] == got[1] > 0
    assert launches["gmm_update"] == 40
    assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
    assert got[3] == 0

    def kept(routed):
        return {f: [(s, b) for s, b in d if abs(s - 0.5) >= 1e-3]
                for f, d in routed.items()}
    a, b = kept(card), kept(cpu)
    assert {f: len(d) for f, d in a.items()} == \
        {f: len(d) for f, d in b.items()}
    for f in a:
        for (sa, ba), (sb, bb) in zip(a[f], b[f]):
            assert abs(sa - sb) <= 1e-4
            assert max(abs(x - y) for x, y in zip(ba, bb)) <= 1e-3


def test_lm_example_on_card_runs_float32_k6(cuda, capsys):
    """K6 once a layer and once with the packed row's segment ids, float32,
    within 1e-4 of its plain version on the card and of the CPU run (the
    weights are drawn on the host)."""
    mod = load_example("torch_lm_sequence_packing")
    reset_launches()
    got = mod.main([])
    assert dict(LAUNCHES) == {**{k: 0 for k in LAUNCHES},
                              "flash_attention": mod.CFG.n_layers + 1}
    h, out = mod.serve_row(got["params"], got["tokens"], got["segment_ids"],
                           impl="torch")
    torch.testing.assert_close(got["hidden"], h, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got["attention"], out, atol=1e-4, rtol=1e-4)
    cpu = mod.main(["--device", "cpu"])
    torch.testing.assert_close(got["hidden"].cpu(), cpu["hidden"],
                               atol=1e-4, rtol=1e-4)
    seg = got["segment_ids"]
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((1, mod.SEQ, 4, 32), generator=gen, device=cuda)
    k, v = (torch.randn((1, mod.SEQ, 2, 32), generator=gen, device=cuda)
            for _ in range(2))
    torch.testing.assert_close(
        attn_ops.flash_attention(q, k, v, causal=True, segment_ids=seg),
        attn_ops.flash_attention(q, k, v, causal=True, segment_ids=seg,
                                 impl="torch"), atol=1e-4, rtol=1e-4)


def test_train_example_on_card_learns_and_restores(cuda, capsys):
    """The example's own assertion (training learns) at 44 steps, the drill
    at step 22 restored; training launches no kernel."""
    mod = load_example("torch_train_detector")
    reset_launches()
    losses, drills = mod.main(["--steps", "44"])
    assert len(losses) == 44 and drills == 1
    assert not any(LAUNCHES.values())
    assert "[drill] host at step 22" in capsys.readouterr().out
