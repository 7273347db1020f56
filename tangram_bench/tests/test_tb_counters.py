"""The benchmark's own counters against hand counts at both
configurations' widths."""
import json
import pathlib

import numpy as np
import pytest

from tangram_bench import counters

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_tangram_flops_per_canvas():
    # ViT-B/32 on 1024^2: 1,024 tokens of width 768
    s, d, dff = 1024, 768, 3072
    embed = 2 * s * 3072 * d                         # 4.83 GFLOP
    layer = 8 * s * d * d + 4 * s * s * d + 4 * s * d * dff
    assert layer == 17_716_740_096
    want = embed + 12 * layer + 2 * s * d * 5
    assert counters.detector_flops_per_canvas(config("tangram")) == want
    assert want / 1e9 == pytest.approx(217.44, abs=0.01)


def test_vit_s16_flops_per_canvas():
    # ViT-S/16 on 1024^2: 4,096 tokens of width 384; attention is 309 GF
    s, d, dff = 4096, 384, 1536
    attn = 12 * 4 * s * s * d
    assert attn / 1e9 == pytest.approx(309.24, abs=0.01)
    want = (2 * s * 768 * d + 12 * (8 * s * d * d + 4 * s * s * d
                                    + 4 * s * d * dff) + 2 * s * d * 5)
    assert counters.detector_flops_per_canvas(config("vit_s16")) == want
    assert want / 1e9 == pytest.approx(485.62, abs=0.01)


def test_touched_tokens_by_hand():
    rec = np.zeros((2, 2, 6), np.int32)
    rec[0, 0] = (1, 0, 0, 0, 32, 32)        # exactly one token at patch 32
    rec[0, 1] = (1, 1, 33, 0, 32, 1)        # straddles tokens 1 and 2
    rec[1, 0] = (1, 2, 990, 990, 34, 34)    # the last two x two tokens
    rec[1, 1] = (0, 0, 0, 0, 1024, 1024)    # invalid: not counted
    assert counters.touched_tokens(rec, 1024, 32) == 1 + 2 + 4


def test_k4_work_and_bound_at_tangram():
    cfg = config("tangram")
    rec = np.zeros((1, 4, 6), np.int32)
    rec[0, 0] = (1, 0, 0, 0, 512, 256)
    ops, nbytes = counters.k4_work(rec, cfg)
    tokens = 16 * 8
    assert ops == 2 * tokens * 3072 * 768
    assert nbytes == (4 * 6 * 4 + 512 * 256 * 3 * 4 + (3072 * 768 + 768) * 2
                      + 1024 * 768 * 2)
    assert counters.k4_bound_s(rec, cfg) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))


def test_k4_work_at_vit_s16():
    cfg = config("vit_s16")
    rec = np.zeros((2, 1, 6), np.int32)
    rec[0, 0] = (1, 0, 8, 8, 16, 16)         # four tokens at patch 16
    rec[1, 0] = (1, 1, 0, 0, 1024, 1024)     # the whole canvas
    ops, nbytes = counters.k4_work(rec, cfg)
    assert ops == 2 * (4 + 4096) * 768 * 384
    assert nbytes == (2 * 6 * 4 + (256 + 1024 * 1024) * 12
                      + (768 * 384 + 384) * 2 + 2 * 4096 * 384 * 2)
