"""The ``vitdet`` family: its weight layout is the port's, leaf for leaf;
its trunk is the port's plain reference's; its operation count is the
hand count of ViTDet-L; a configuration that differs from the registry's
model stops set-up; and a tiny ViTDet cell runs through the harness on
the CPU, correct, with the three readers of the trunk's device-timed
records reading it (and nothing where the records are missing)."""
import json

import pytest
import torch
from tb_fixtures import tiny_config, tiny_traffic

from tangram_bench import families, harness, weights
from tangram_bench.families import vitdet

VITDET = dict(family="vitdet", window=3, global_every=2, rel_pos=True,
              attn_bias=True, gelu="erf", n_layers=4)
READERS = ("window_attn_ms_per_canvas.replay",
           "global_attn_ms_per_canvas.replay", "detector_mfu_pct.replay")


def vitdet_l() -> dict:
    with open(harness.BENCH_DIR / "configs" / "vitdet_l.json") as f:
        return json.load(f)


def port_leaves(cfg: dict):
    from repro_torch.models import detector

    def walk(tree, pre=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, pre + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, pre + (i,))
        else:
            yield pre, tuple(tree.shape)
    return list(walk(detector.param_specs(harness.detector_config(cfg))))


@pytest.mark.parametrize("cfg", [vitdet_l(), tiny_config(**VITDET)],
                         ids=["vitdet_l", "tiny"])
def test_leaf_specs_are_the_ports_leaf_for_leaf(cfg):
    assert families.load(cfg) is vitdet
    assert [(p, s) for p, s, _, _ in vitdet.leaf_specs(cfg)] == \
        port_leaves(cfg)


def test_published_widths_and_the_count_of_parameters():
    cfg = vitdet_l()
    arch = harness.detector_config(cfg)
    assert weights.n_params(cfg) == arch.n_params == 307_432_453
    assert vitdet.windows_of(cfg) == [0 if i in (5, 11, 17, 23) else 14
                                      for i in range(24)]


def test_detector_raw_is_the_ports_reference(cpu):
    from repro_torch.models import vitdet_reference
    cfg = tiny_config(**VITDET, canvas=160)          # a 10x10 grid
    w = weights.make_weights(cfg, 5, cpu, torch.float32)
    tokens = torch.randn((2, 100, 64),
                         generator=torch.Generator().manual_seed(7))
    arch = harness.detector_config(cfg)
    want = vitdet_reference.forward_tokens(arch, w, tokens)
    got = vitdet.detector_raw(tokens, w, 10, 1e-6)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # the controls: no relative positions; every block global
    for rel_pos, windows in ((False, None), (True, [0] * 4)):
        got = vitdet.trunk_raw(tokens, w, 10, 1e-6, rel_pos=rel_pos,
                               windows=windows)
        want = vitdet_reference.forward_tokens(
            arch, w, tokens, windows=windows, use_rel_pos=rel_pos)
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())


def test_flops_per_canvas_is_the_hand_count():
    d, dff, s, padded = 1024, 4096, 64 * 64, 70 * 70
    mlp = 24 * 2 * 2 * s * d * dff
    proj = 20 * 2 * padded * d * d * 4 + 4 * 2 * s * d * d * 4
    products = 20 * 25 * 2 * 2 * 196 * 196 * d + 4 * 2 * 2 * s * s * d
    rel = 20 * 2 * 2 * padded * 14 * d + 4 * 2 * 2 * s * 64 * d
    embed, head = 2 * s * 768 * d, 2 * s * d * 5
    want = mlp + proj + products + rel + embed + head
    assert vitdet.flops_per_canvas(vitdet_l()) == want
    # the issue's table: 1,649 + 960 + 354 + 10 GFLOP, and the embed
    assert round(mlp / 1e9) == 1649 and round(proj / 1e9) == 960
    assert round(products / 1e9) == 354 and round(rel / 1e9) == 10
    assert want == pytest.approx(2.979e12, rel=1e-3)


@pytest.mark.parametrize("key,value", [("window", 7), ("global_every", 4),
                                       ("rel_pos", False),
                                       ("attn_bias", False),
                                       ("gelu", "tanh"), ("d_ff", 2048)])
def test_a_configuration_unlike_the_registry_stops_set_up(key, value):
    cfg = dict(vitdet_l(), **{key: value})
    with pytest.raises(ValueError, match=f"differs from vitdet_l.json in "
                                         f"\\['{key}'\\]"):
        harness.detector_config(cfg)


def test_a_tiny_vitdet_cell_is_correct_and_its_records_are_read(cpu):
    from repro_torch.core import spans
    from tangram_bench import program_spans
    installed = spans.LOG                   # program_spans' own, if loaded
    log = spans.SpanLog()
    spans.install(log)
    try:
        checks, data, _, _ = harness.run_checked(
            tiny_config(**VITDET), tiny_traffic("replay"), 2718281828, cpu,
            3.0)
        got = {name: harness.load_reader(name)(data) for name in READERS}
    finally:
        spans.LOG = installed
    lim = harness.limits_of(tiny_config(**VITDET))
    assert all(checks[k] <= lim[k] for k in lim), checks
    assert program_spans.records(data)
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["detector_mfu_pct.replay"] < 100
    # a program without the records: nothing to read, nothing raised
    data.program_spans = [r for r in data.program_spans
                          if r is None or not r[0].startswith("trunk")]
    assert all(harness.load_reader(name)(data) is None for name in READERS)
