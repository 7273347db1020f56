"""The plain ViT trunk: pre-norm blocks, global softmax attention with no
q/k/v bias, tanh GELU MLP, a final layernorm and the 5-channel head on
every token (``repro_torch.models.detector``'s layout)."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from tangram_bench.reference import (NORM_EPS, f32, full_float32, layernorm,
                                     mm)

#: the configuration keys that equal the registry model's attributes
KEYS = ("canvas", "patch", "n_layers", "d_model", "n_heads", "d_ff",
        "param_dtype", "compute_dtype")


def leaf_specs(cfg: dict) -> List[Tuple[tuple, tuple, str, int]]:
    """(path, shape, init, fan_in) of every leaf, in tree order."""
    d, h, dff, p = cfg["d_model"], cfg["n_heads"], cfg["d_ff"], cfg["patch"]
    dh = d // h
    side = cfg["canvas"] // p
    out = [(("trunk", "patch_embed", "kernel"), (p * p * 3, d), "w", p * p * 3),
           (("trunk", "patch_embed", "bias"), (d,), "b", 0),
           (("trunk", "pos_embed"), (1, side * side, d), "b", 0)]
    for i in range(cfg["n_layers"]):
        pre = ("trunk", "layers", i)
        out += [(pre + ("ln1", "scale"), (d,), "scale", 0),
                (pre + ("ln1", "bias"), (d,), "b", 0),
                (pre + ("attn", "wq"), (d, h, dh), "w", d),
                (pre + ("attn", "wk"), (d, h, dh), "w", d),
                (pre + ("attn", "wv"), (d, h, dh), "w", d),
                (pre + ("attn", "wo"), (h, dh, d), "out", d),
                (pre + ("ln2", "scale"), (d,), "scale", 0),
                (pre + ("ln2", "bias"), (d,), "b", 0),
                (pre + ("mlp", "fc1", "kernel"), (d, dff), "w", d),
                (pre + ("mlp", "fc1", "bias"), (dff,), "b", 0),
                (pre + ("mlp", "fc2", "kernel"), (dff, d), "out", dff),
                (pre + ("mlp", "fc2", "bias"), (d,), "b", 0)]
    out += [(("trunk", "ln_f", "scale"), (d,), "scale", 0),
            (("trunk", "ln_f", "bias"), (d,), "b", 0),
            (("det_head", "kernel"), (d, 5), "w", d),
            (("det_head", "bias"), (5,), "b", 0)]
    return out


def block(lp: dict, x: torch.Tensor, eps: float, matmul=mm
          ) -> torch.Tensor:
    """One pre-norm encoder block on one canvas, x (S, d)."""
    a = lp["attn"]
    d = x.shape[-1]
    h = layernorm(lp["ln1"], x, eps)

    def heads(w):                                   # (d, H, Dh) -> (H, S, Dh)
        hh, dh = w.shape[1], w.shape[2]
        return matmul(h, f32(w).reshape(d, hh * dh)).reshape(
            -1, hh, dh).transpose(0, 1)

    q, k, v = heads(a["wq"]), heads(a["wk"]), heads(a["wv"])
    scores = matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    ctx = matmul(torch.softmax(scores, dim=-1), v)          # (H, S, Dh)
    wo = f32(a["wo"])
    x = x + matmul(ctx.transpose(0, 1).reshape(-1, wo.shape[0] * wo.shape[1]),
                   wo.reshape(-1, d))
    h = layernorm(lp["ln2"], x, eps)
    mlp = lp["mlp"]
    u = F.gelu(matmul(h, f32(mlp["fc1"]["kernel"]))
               + f32(mlp["fc1"]["bias"]), approximate="tanh")
    return (x + matmul(u, f32(mlp["fc2"]["kernel"]))
            + f32(mlp["fc2"]["bias"]))


@torch.no_grad()
def detector_raw(tokens: torch.Tensor, weights: dict, side: int,
                 eps: float = NORM_EPS, matmul=mm) -> torch.Tensor:
    """Embedded tokens (B, S, d) -> raw head (B, side, side, 5)."""
    tp = weights["trunk"]
    head = weights["det_head"]
    out = []
    with full_float32():
        for x in tokens:
            x = f32(x) + f32(tp["pos_embed"][0])
            for lp in tp["layers"]:
                x = block(lp, x, eps, matmul)
            x = layernorm(tp["ln_f"], x, eps)
            out.append(matmul(x, f32(head["kernel"])) + f32(head["bias"]))
    return torch.stack(out).reshape(tokens.shape[0], side, side, 5)


def flops_per_canvas(cfg: dict) -> float:
    """Multiply-adds x 2 of one canvas through the detector: the patch
    embed over every token, per layer the Q/K/V/O projections, the two
    attention products (S x S) and the MLP, and the 5-channel head.
    Norms, softmax and activations are not counted."""
    d, dff, p = cfg["d_model"], cfg["d_ff"], cfg["patch"]
    s = (cfg["canvas"] // p) ** 2
    embed = 2 * s * (p * p * 3) * d
    per_layer = 2 * s * d * d * 4 + 2 * 2 * s * s * d + 2 * 2 * s * d * dff
    head = 2 * s * d * 5
    return float(embed + cfg["n_layers"] * per_layer + head)
