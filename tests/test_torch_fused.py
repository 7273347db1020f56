"""The fused serving path (K4 stitch->embed, K3 decode->gather): the port's
plain versions, routing and fused pipeline against the JAX package on the
same numpy inputs, at the JAX tests' sizes (canvas 128, patch 32).

The JAX fused Pallas stitch->embed kernel cannot run on this tree (ROADMAP
F1), so K4's plain version is held against ``stitch_embed_reference``; K3's
against both ``unstitch_decode_pallas(interpret=True)`` and
``unstitch_decode_reference``.  Tolerances: 1e-4 in float32 and 2e-2 in
bfloat16 for the embed (summation order differs between XLA and PyTorch's
CPU matmuls; a bf16 output may round one ulp apart), 1e-5 for the decode
(the same elementwise float32 math in both), equality for routing.  The
hand-written CUDA kernels are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partitioning import Patch as JPatch
from repro.core.stitching import build_batch_plan as jbuild
from repro.core.stitching import stitch as jstitch
from repro.kernels.stitch import ops as jops
from repro.kernels.stitch.fused_embed import unstitch_decode_pallas
from repro.kernels.stitch.ref import (stitch_embed_reference,
                                      unstitch_decode_reference)
from repro.launch import serve as jserve
from repro.models import detector as jdet
from repro_torch.config import DetectorConfig
from repro_torch.core.engine import make_executor
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.kernels.stitch import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import detector as tdet

M = 128
PATCH = 32
D = 64
CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _plan(kind, seed):
    """Packer-built plan with non-square placements ("random"), one flush
    with the canvas edges, one whose records are all invalid, or an empty
    one; returns the port's plan, its patches and the slots."""
    rng = np.random.default_rng(seed)
    if kind == "flush":
        sizes = [(M // 2, M // 2)] * 4 + [(M, M), (M - 24, 16), (24, M)]
    elif kind == "empty":
        sizes = []
    else:
        sizes = [(int(rng.integers(8, M // 2 + 1)),
                  int(rng.integers(8, M // 2 + 1))) for _ in range(9)]
    patches = [Patch(0, 0, w, h, frame_id=i % 3)
               for i, (w, h) in enumerate(sizes)]
    plan = build_batch_plan(patches, stitch(patches, M, M), M, M)
    jpatches = [JPatch(**dataclasses.asdict(p)) for p in patches]
    jplan = jbuild(jpatches, jstitch(jpatches, M, M), M, M)
    np.testing.assert_array_equal(plan.records, jplan.records)
    crops = [rng.normal(size=(p.h, p.w, 3)).astype(np.float32)
             for p in patches]
    slots = ops.pack_plan_host(crops, plan)
    if kind == "invalid":
        records = plan.records.copy()
        records[..., 0] = 0
        plan = dataclasses.replace(plan, records=records)
    return plan, patches, slots


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("kind", ["random", "flush", "invalid", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stitch_embed_plain_matches_reference(dtype, kind):
    jdt, tdt, tol = DTYPES[dtype]
    plan, _, slots = _plan(kind, seed=7)
    rng = np.random.default_rng(1)
    kernel = (rng.normal(size=(PATCH * PATCH * 3, D)) * 0.05).astype(
        np.float32)
    bias = rng.normal(size=(D,)).astype(np.float32)
    tk, tb = torch.from_numpy(kernel).to(tdt), torch.from_numpy(bias).to(tdt)

    got = ops.stitch_embed(torch.from_numpy(slots),
                           torch.from_numpy(plan.records), tk, tb, M, M,
                           PATCH)
    seq = (M // PATCH) ** 2
    assert got.shape == (plan.num_canvases, seq, D) and got.dtype == tdt
    want = stitch_embed_reference(
        jnp.asarray(slots), jnp.asarray(plan.records), jnp.asarray(kernel,
                                                                   jdt),
        jnp.asarray(bias, jdt), M, M, PATCH)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if kind == "invalid":
        # no placement covers any pixel: exactly the bias in the kernel dtype
        assert plan.num_canvases > 0
        assert torch.equal(got, tb.expand(plan.num_canvases, seq, D))


@pytest.mark.parametrize("kind", ["random", "flush", "invalid", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unstitch_decode_plain_matches_pallas_and_reference(dtype, kind):
    jdt, tdt, _ = DTYPES[dtype]
    plan, _, _ = _plan(kind, seed=8)
    side = M // PATCH
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(plan.num_canvases, side, side, 5)).astype(
        np.float32)
    jraw, jrec = jnp.asarray(raw, jdt), jnp.asarray(plan.records)
    cap = plan.slot_capacity

    got = ops.unstitch_decode(torch.from_numpy(raw).to(tdt),
                              torch.from_numpy(plan.records), PATCH, cap)
    assert got.shape == (cap, side, side, 5) and got.dtype == torch.float32
    # everywhere, unreferenced slots included (zero in both)
    want = unstitch_decode_reference(jraw, jrec, PATCH, cap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    # on the referenced slots (the Pallas kernel leaves the rest undefined)
    live = sorted(slot for _, slot, *_ in plan.placements())
    pallas = unstitch_decode_pallas(jraw, jrec, PATCH, cap, interpret=True)
    np.testing.assert_allclose(got.numpy()[live], _np(pallas)[live],
                               atol=1e-5, rtol=1e-5)
    if kind in ("random", "flush"):
        assert (got[..., 0] > 0).any()      # some cells were claimed


def test_route_fused_matches_reference():
    plan, patches, _ = _plan("random", seed=13)
    side = M // PATCH
    rng = np.random.default_rng(6)
    raw = rng.normal(size=(plan.num_canvases, side, side, 5)).astype(
        np.float32)
    grids = np.asarray(unstitch_decode_reference(
        jnp.asarray(raw), jnp.asarray(plan.records), PATCH,
        plan.slot_capacity))
    jpatches = [JPatch(**dataclasses.asdict(p)) for p in patches]
    jplan = jbuild(jpatches, jstitch(jpatches, M, M), M, M)
    want = jops.route_fused(jplan, jpatches, grids)
    got = ops.route_fused(plan, patches, grids)
    assert sum(len(v) for v in want.values()) > 0
    assert got == want


def _detector(dtype="float32", noise=0.3):
    """``repro.launch.serve``'s detector at canvas 128 (optionally in bf16), its
    inits perturbed so the head fires on some cells, and the port's copy."""
    cfg, params, serve_fn, rules = jserve.build_detector(canvas=M)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        (x + jnp.asarray(rng.normal(size=x.shape) * noise, x.dtype)).astype(
            dtype) for x in leaves])
    tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(DetectorConfig)
                             if hasattr(cfg, f.name)})
    tparams = tdet.convert_params(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, CPU)
    return (cfg, params, serve_fn, rules), (tcfg, tparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_params_after_convert_params(dtype):
    (cfg, params, _, _), (tcfg, tparams) = _detector(dtype)
    jk, jb = jdet.embed_params(cfg, params)
    tk, tb = tdet.embed_params(tcfg, tparams)
    for j, t in ((jk, tk), (jb, tb)):
        assert t.dtype == getattr(torch, dtype) and t.shape == j.shape
        if dtype == "bfloat16":     # bit for bit
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(j).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _margin_filter(per_frame, threshold=0.5, margin=1e-3):
    return {fid: kept for fid, dets in per_frame.items()
            if (kept := [(s, b) for s, b in dets
                         if abs(s - threshold) >= margin])}


@pytest.mark.parametrize("seed", [9, 21])
def test_fused_pipeline_matches_jax_unfused_pipeline(seed):
    """Port: K4 plain -> trunk from tokens -> K3 plain -> route_fused.
    JAX: stitch -> detector -> decode -> route_detections.  Routed
    detections agree within the JAX fused test's tolerances."""
    (cfg, params, serve_fn, _), (tcfg, tparams) = _detector()
    plan, patches, slots = _plan("random", seed)
    jpatches = [JPatch(**dataclasses.asdict(p)) for p in patches]
    jplan = jbuild(jpatches, jstitch(jpatches, M, M), M, M)
    canvases = jops.stitch_canvases(jnp.asarray(slots),
                                    jnp.asarray(plan.records), M, M)
    obj, boxes = serve_fn(params, canvases)
    want = jops.route_detections(jplan, jpatches, np.asarray(obj),
                                 np.asarray(boxes))

    kernel, bias = tdet.embed_params(tcfg, tparams)
    records = torch.from_numpy(plan.records)
    tokens = ops.stitch_embed(torch.from_numpy(slots), records, kernel, bias,
                              M, M, tcfg.patch)
    raw = tdet.tokens_fn(tcfg)(tparams, tokens)
    grids = ops.unstitch_decode(raw, records, tcfg.patch, plan.slot_capacity)
    got = ops.route_fused(plan, patches, grids.numpy())

    want, got = _margin_filter(want), _margin_filter(got)
    assert sum(len(v) for v in want.values()) > 0
    assert set(got) == set(want)
    for fid in want:
        assert len(got[fid]) == len(want[fid]), fid
        for (gs, gb), (ws, wb) in zip(got[fid], want[fid]):
            assert gs == pytest.approx(ws, abs=1e-4)
            assert gb == pytest.approx(wb, abs=1e-3)


@pytest.mark.parametrize("missing", ["tokens_fn", "embed_kernel",
                                     "embed_bias", "patch"])
@pytest.mark.parametrize("executor", ["device", "async_device"])
def test_fuse_without_fused_fields_raises(executor, missing):
    _, (tcfg, tparams) = _detector()
    kw = tserve.fused_kwargs(tcfg, tparams)
    kw[missing] = None
    with pytest.raises(ValueError, match=missing):
        make_executor(executor, serve_fn=tdet.serve_fn(tcfg), params=tparams,
                      canvas_m=M, canvas_n=M, device="cpu", **kw)


def test_fuse_needs_canvas_multiple_of_patch():
    _, (tcfg, tparams) = _detector()
    with pytest.raises(ValueError, match="multiple"):
        make_executor("device", serve_fn=tdet.serve_fn(tcfg), params=tparams,
                      canvas_m=M + 16, canvas_n=M, device="cpu",
                      **tserve.fused_kwargs(tcfg, tparams))


def test_cuda_impl_on_cpu_tensor_raises():
    plan, _, slots = _plan("random", seed=3)
    records = torch.from_numpy(plan.records)
    kernel = torch.zeros((PATCH * PATCH * 3, D))
    bias = torch.zeros((D,))
    with pytest.raises(ValueError, match="CUDA"):
        ops.stitch_embed(torch.from_numpy(slots), records, kernel, bias, M,
                         M, PATCH, impl="cuda")
    raw = torch.zeros((plan.num_canvases, M // PATCH, M // PATCH, 5))
    with pytest.raises(ValueError, match="CUDA"):
        ops.unstitch_decode(raw, records, PATCH, plan.slot_capacity,
                            impl="cuda")
    with pytest.raises(ValueError, match="unknown stitch impl"):
        ops.unstitch_decode(raw, records, PATCH, plan.slot_capacity,
                            impl="pallas")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unstitch_decode_last_record_naming_a_slot_wins(dtype):
    """Two valid records naming one slot (in one canvas and across
    canvases): the plain K3, the JAX oracle and the Pallas kernel
    (interpret mode) keep the later record's grid in (b, k) order; a slot
    no valid record names is zero (the Pallas kernel leaves it undefined).
    Placements start off the cell grid and some raw centres saturate, so
    decoded centres land on cell edges."""
    rng = np.random.default_rng(23)
    side, b, k, cap = M // PATCH, 2, 5, 7
    w = rng.integers(40, M - 8, size=(b, k))
    h = rng.integers(40, M - 8, size=(b, k))
    x = rng.integers(0, M - w + 1)
    y = rng.integers(0, M - h + 1)
    slot = np.array([[0, 1, 2, 1, 3], [4, 2, 5, 0, 3]])
    valid = np.ones((b, k), np.int64)
    valid[1, 4] = 0                   # slot 3: the earlier record stays
    records = np.stack([valid, slot, x, y, w, h], -1).astype(np.int32)
    raw = rng.normal(size=(b, side, side, 5)).astype(np.float32)
    raw[..., 1:3] = np.where(rng.random((b, side, side, 2)) < 0.5,
                             raw[..., 1:3],
                             rng.choice([-30.0, 30.0],
                                        size=(b, side, side, 2)))
    jdt, tdt, _ = DTYPES[dtype]
    jraw, jrec = jnp.asarray(raw, jdt), jnp.asarray(records)

    got = ops.unstitch_decode(torch.from_numpy(raw).to(tdt),
                              torch.from_numpy(records), PATCH, cap)
    want = _np(unstitch_decode_reference(jraw, jrec, PATCH, cap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    live = sorted(set(slot[valid > 0].tolist()))
    pallas = _np(unstitch_decode_pallas(jraw, jrec, PATCH, cap,
                                        interpret=True))
    np.testing.assert_allclose(got.numpy()[live], pallas[live], atol=1e-5,
                               rtol=1e-5)
    assert not got.numpy()[6].any()                      # never named
    # slot 1 (k 1 and 3 of canvas 0), 2 (canvas 0 k 2, canvas 1 k 1) and 0
    # (canvas 0 k 0, canvas 1 k 3): the later record's grid alone
    named_twice = {1: (0, 3), 2: (1, 1), 0: (1, 3), 3: (0, 4)}
    assert (got.numpy()[list(named_twice)][..., 0] > 0).any()
    for s, (bi, ki) in named_twice.items():
        alone = records.copy()
        alone[..., 0] = 0
        alone[bi, ki, 0] = 1
        single = ops.unstitch_decode(torch.from_numpy(raw).to(tdt),
                                     torch.from_numpy(alone), PATCH, cap)
        np.testing.assert_array_equal(got.numpy()[s], single.numpy()[s])
