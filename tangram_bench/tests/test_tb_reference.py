"""The plain reference against the port at a tiny size: the packer, K4's
plain stitch->embed, the trunk, K3's plain decode->gather and the
routing; then a whole run through the engine."""

import numpy as np
import pytest
import torch
from tb_fixtures import tiny_config, tiny_traffic

from repro_torch.config import DetectorConfig
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.kernels.stitch import ops as stitch_ops
from repro_torch.kernels.stitch.ref import (stitch_embed_reference,
                                            unstitch_decode_reference)
from repro_torch.models import detector as detector_lib
from tangram_bench import families, harness, reference
from tangram_bench.weights import make_weights, n_params

KEYS = ("canvas", "patch", "n_layers", "d_model", "n_heads", "d_ff")


def arch(cfg, dtype="float32"):
    return DetectorConfig(name="tiny", param_dtype=dtype,
                          compute_dtype=dtype, **{k: cfg[k] for k in KEYS})


def random_patches(rng, n, canvas):
    out = []
    for i in range(n):
        w, h = (int(v) for v in rng.integers(8, canvas, 2))
        x0, y0 = (int(v) for v in rng.integers(0, 400, 2))
        out.append(Patch(x0, y0, x0 + w, y0 + h, frame_id=i % 3,
                         camera_id=i % 3))
    return out


def flat_paths(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, pre + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_paths(v, pre + (i,))
    else:
        yield pre, tree


@pytest.mark.parametrize("name", ["tiny", "tangram", "vit_s16"])
def test_weight_tree_has_the_detectors_layout(name):
    cfg = (tiny_config() if name == "tiny" else
           harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json"))
    specs = dict(flat_paths(detector_lib.param_specs(arch(cfg))))
    if name != "tiny":
        ours = {p: s for p, s, _, _ in families.load(cfg).leaf_specs(cfg)}
        assert {p: tuple(s.shape) for p, s in specs.items()} == ours
        return
    tree = make_weights(cfg, 3, torch.device("cpu"))
    got = dict(flat_paths(tree))
    assert {p: tuple(t.shape) for p, t in got.items()} == \
        {p: tuple(s.shape) for p, s in specs.items()}
    assert sum(t.numel() for t in got.values()) == n_params(cfg)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    k = tree["trunk"]["patch_embed"]["kernel"]
    assert k.data_ptr() % 16 == 0


def test_packer_and_records_equal_the_ports():
    rng = np.random.default_rng(0)
    for trial in range(20):
        patches = random_patches(rng, int(rng.integers(1, 40)), 128)
        canv = stitch(patches, 128, 128)
        plan = build_batch_plan(patches, canv, 128, 128)
        ref = reference.plan([(p.w, p.h) for p in patches], 128, 128)
        assert np.array_equal(ref["records"], plan.records)
        assert (ref["hmax"], ref["wmax"], ref["slot_capacity"]) == \
            (plan.hmax, plan.wmax, plan.slot_capacity)


def invocation(seed=0, n=12):
    rng = np.random.default_rng(seed)
    patches = random_patches(rng, n, 128)
    ref = reference.plan([(p.w, p.h) for p in patches], 128, 128)
    crops = [rng.random((p.h, p.w, 3), dtype=np.float32) for p in patches]
    return patches, ref, crops


def test_stitch_embed_and_trunk_equal_the_ports_in_float32():
    cfg = tiny_config()
    a = arch(cfg)
    weights = make_weights(cfg, 5, torch.device("cpu"), torch.float32)
    patches, ref, crops = invocation()
    cpu = torch.device("cpu")
    canvases = reference.stitch(crops, ref["records"], 128, 128, cpu)
    with reference.full_float32():
        tokens = reference.embed(canvases, weights, 16)
        raw = families.load(cfg).detector_raw(tokens, weights, 8)
    slots = torch.from_numpy(stitch_ops.pack_plan_host(
        crops, build_batch_plan(patches, stitch(patches, 128, 128), 128,
                                128)))
    kernel, bias = detector_lib.embed_params(a, weights)
    port_tokens = stitch_embed_reference(
        slots, torch.from_numpy(ref["records"]), kernel, bias, 128, 128, 16)
    torch.testing.assert_close(tokens, port_tokens, atol=1e-5, rtol=1e-5)
    port_raw = detector_lib.forward_tokens(a, weights, port_tokens)
    torch.testing.assert_close(raw, port_raw, atol=1e-4, rtol=1e-4)


def test_decode_gather_and_route_equal_the_ports():
    patches, ref, _ = invocation(1)
    records = ref["records"]
    raw = torch.randn((records.shape[0], 8, 8, 5),
                      generator=torch.Generator().manual_seed(2)) * 2
    ours = reference.decode_gather(raw, records, 16, ref["slot_capacity"])
    port = unstitch_decode_reference(raw, torch.from_numpy(records), 16,
                                     ref["slot_capacity"])
    torch.testing.assert_close(ours, port, atol=1e-6, rtol=1e-6)
    plan = build_batch_plan(patches, stitch(patches, 128, 128), 128, 128)
    routed = reference.route(records, [(p.frame_id, p.x0, p.y0)
                                       for p in patches], ours.numpy())
    assert routed == stitch_ops.route_fused(plan, patches, ours.numpy())
    assert sum(len(v) for v in routed.values()) > 0


@pytest.mark.parametrize("mode", ["replay", "live"])
def test_a_run_through_the_engine_is_correct(mode, cpu):
    cfg = tiny_config()
    checks, data, _, _ = harness.run_checked(cfg, tiny_traffic(mode), 77,
                                             cpu, 1.5)
    lim = harness.limits_of(cfg)
    assert all(checks[k] <= lim[k] for k in lim), checks
    assert data.invs and all(r.t_routed is not None for r in data.invs)
    assert all(tr is not None for _, tr in data.patches)
    # the check read outputs with detections in them
    assert any(r.detections for r in data.invs)
