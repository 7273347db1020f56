"""The harness with the timed path broken underneath: each fault the
cells can have must come out as not correct.  The look for a chip is
skipped; the rest of a run is driven as the command drives it."""
import sys
import types

import pytest
import torch
from tb_fixtures import tiny_config, tiny_traffic

from repro_torch.core import stitching
from repro_torch.kernels.stitch import ops as stitch_ops
from repro_torch.models import detector as detector_lib
from tangram_bench import harness, reference
from tangram_bench.families import vit


def correct(checks, cfg) -> bool:
    lim = harness.limits_of(cfg)
    return all(checks[k] <= lim[k] for k in lim)


def run(cpu, mode="replay"):
    cfg = tiny_config()
    checks, *_ = harness.run_checked(cfg, tiny_traffic(mode), 4242, cpu, 1.0)
    return cfg, checks


def test_the_unbroken_path_is_correct(cpu):
    cfg, checks = run(cpu)
    assert correct(checks, cfg), checks


def test_half_of_the_batch_left_out(cpu, monkeypatch):
    """The trunk runs the first half of the canvases and gives the rest
    the mean of what it ran."""
    real = detector_lib.forward_tokens

    def half(cfg, params, tokens):
        b = tokens.shape[0]
        keep = max(1, b // 2)
        raw = real(cfg, params, tokens[:keep])
        fill = raw.mean(dim=0, keepdim=True).expand(b - keep, *raw.shape[1:])
        return torch.cat([raw, fill])
    monkeypatch.setattr(detector_lib, "forward_tokens", half)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["head_err"] > cfg["limits"]["head_err"]


def test_a_token_altered_where_k4_makes_it(cpu, monkeypatch):
    real = stitch_ops.stitch_embed

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0] += 4.0
        return out
    monkeypatch.setattr(stitch_ops, "stitch_embed", altered)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["k4_token_err"] > cfg["limits"]["k4_token_err"]


def test_a_grid_cell_altered_where_k3_makes_it(cpu, monkeypatch):
    real = stitch_ops.unstitch_decode

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0, 0, 1:] += 0.5
        return out
    monkeypatch.setattr(stitch_ops, "unstitch_decode", altered)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["k3_grid_err"] > cfg["limits"]["k3_grid_err"]


def test_the_head_laid_out_wrong_before_k3(cpu, monkeypatch):
    """The trunk's head comes out transposed and K3 decodes it as it is:
    K3 is right on the head it was given, the head is wrong against the
    reference's own."""
    real = detector_lib.forward_tokens

    def transposed(cfg, params, tokens):
        return real(cfg, params, tokens).transpose(1, 2).contiguous()
    monkeypatch.setattr(detector_lib, "forward_tokens", transposed)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["k3_grid_err"] == 0
    assert checks["head_err"] > cfg["limits"]["head_err"]


def test_an_answer_altered_where_routing_makes_it(cpu, monkeypatch):
    real = stitch_ops.route_fused

    def altered(*args, **kw):
        out = real(*args, **kw)
        for dets in out.values():
            if dets:
                score, (x0, y0, x1, y1) = dets[0]
                dets[0] = (score, (x0 + 1.0, y0, x1, y1))
                break
        return out
    monkeypatch.setattr(stitch_ops, "route_fused", altered)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["route_mismatch"] > 0


def test_a_detection_routed_to_the_wrong_frame(cpu, monkeypatch):
    real = stitch_ops.route_fused

    def moved(*args, **kw):
        out = real(*args, **kw)
        return {fid + 1: dets for fid, dets in out.items()}
    monkeypatch.setattr(stitch_ops, "route_fused", moved)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["route_outside"] > 0


def test_the_packer_placing_off_its_rule(cpu, monkeypatch):
    """The invoker's packer taking the first fitting free rectangle, not
    the best short side."""
    def first_fit(free, w, h):
        return next((i for i, c in enumerate(free)
                     if c.w >= w and c.h >= h), None)
    monkeypatch.setattr(stitching, "_choose", first_fit)
    cfg, checks = run(cpu)
    assert not correct(checks, cfg)
    assert checks["plan_mismatch"] > 0


def test_a_family_that_departs_from_the_program_is_not_correct(cpu,
                                                               monkeypatch):
    """A family whose reference takes the softmax over the first half of
    the keys only, the program unchanged: the family's ``detector_raw``
    is what the program's head is held to, so the run is not correct."""
    def detector_raw(tokens, weights, side, eps=reference.NORM_EPS,
                     matmul=reference.mm):
        def half_keys(a, b):
            # the attention weights (H, S, S) times V (H, S, Dh), in every
            # precision: the yardstick and the control depart alike
            s = a.shape[-1]
            if a.dim() == 3 and a.shape[-2] == s == b.shape[-2]:
                p = a[..., :s // 2]
                a = torch.cat([p / p.sum(-1, keepdim=True),
                               torch.zeros_like(a[..., s // 2:])], -1)
            return matmul(a, b)
        return vit.detector_raw(tokens, weights, side, eps, half_keys)

    family = types.ModuleType("tangram_bench.families.half_keys")
    family.KEYS, family.leaf_specs = vit.KEYS, vit.leaf_specs
    family.flops_per_canvas = vit.flops_per_canvas
    family.detector_raw = detector_raw
    monkeypatch.setitem(sys.modules, family.__name__, family)
    cfg = tiny_config(family="half_keys")
    checks, *_ = harness.run_checked(cfg, tiny_traffic(), 4242, cpu, 1.0)
    assert not correct(checks, cfg)
    assert checks["head_err"] > cfg["limits"]["head_err"]
    assert checks["k4_token_err"] <= cfg["limits"]["k4_token_err"]


def test_the_control_is_not_correct(cpu):
    """The reference in fp8 in the program's place fails the shipped
    limits of both configurations at the tiny size too."""
    cfg = tiny_config()
    (prog, ctl), *_ = harness.run_checked(cfg, tiny_traffic(), 99, cpu, 1.0,
                                          control=True)
    for name in ("tangram", "vit_s16"):
        shipped = harness.load_json(harness.BENCH_DIR / "configs"
                                    / f"{name}.json")
        lim = harness.limits_of(shipped)
        assert all(prog[k] <= lim[k] for k in lim), (name, prog)
        assert not all(ctl[k] <= lim[k] for k in lim), (name, ctl)


def test_fp8_rounding():
    x = torch.tensor([448.0, 1.0, 0.0, -3.3])
    q = reference.fp8(x)
    assert q[0] == 448.0 and q[2] == 0.0
    assert q[3] == pytest.approx(-3.25)      # 3 mantissa bits
