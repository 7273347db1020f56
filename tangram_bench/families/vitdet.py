"""The ViTDet trunk (Li, Mao, Girshick, He, arXiv:2203.16527; Detectron2's
``modeling/backbone/vit.py``): pre-norm blocks with q/k/v and output
biases, softmax attention within windows, zero-padded after the first
norm and not masked, but in every ``global_every``-th block, which
attends over the whole grid; decomposed relative-position terms added to
every block's logits (``q . Rh[i_h - j_h] + q . Rw[i_w - j_w]``, the
unscaled q); the exact (erf) GELU MLP; then the system's final
layernorm and 5-channel head on every token.

``detector_raw`` is given no configuration, so it reads each block's
window from its ``rel_pos_h`` table, (2 w - 1) rows for a w x w grid: a
block whose w is the grid's side is global.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tangram_bench.reference import (NORM_EPS, f32, full_float32, layernorm,
                                     mm)

#: the configuration keys that equal the registry model's attributes
KEYS = ("canvas", "patch", "n_layers", "d_model", "n_heads", "d_ff",
        "param_dtype", "compute_dtype", "window", "global_every", "rel_pos",
        "attn_bias", "gelu")


def windows_of(cfg: dict) -> List[int]:
    """Each block's window side; 0 where it attends globally."""
    every = cfg["global_every"]
    return [0 if every and (i + 1) % every == 0 else cfg["window"]
            for i in range(cfg["n_layers"])]


def leaf_specs(cfg: dict) -> List[Tuple[tuple, tuple, str, int]]:
    """(path, shape, init, fan_in) of every leaf, in tree order.  The
    relative-position tables draw as kernels of fan-in Dh (``assumed`` in
    the configuration file): each term then reads about as large as the
    content logits."""
    d, h, dff, p = cfg["d_model"], cfg["n_heads"], cfg["d_ff"], cfg["patch"]
    dh = d // h
    side = cfg["canvas"] // p
    k = p * p * 3
    out = [(("trunk", "patch_embed", "kernel"), (k, d), "w", k),
           (("trunk", "patch_embed", "bias"), (d,), "b", 0),
           (("trunk", "pos_embed"), (1, side * side, d), "b", 0)]
    for i, window in enumerate(windows_of(cfg)):
        pre = ("trunk", "layers", i)
        rows = 2 * (window or side) - 1
        out += [(pre + ("ln1", "scale"), (d,), "scale", 0),
                (pre + ("ln1", "bias"), (d,), "b", 0),
                (pre + ("attn", "wq"), (d, h, dh), "w", d),
                (pre + ("attn", "wk"), (d, h, dh), "w", d),
                (pre + ("attn", "wv"), (d, h, dh), "w", d),
                (pre + ("attn", "wo"), (h, dh, d), "out", d),
                (pre + ("attn", "bq"), (h, dh), "b", 0),
                (pre + ("attn", "bk"), (h, dh), "b", 0),
                (pre + ("attn", "bv"), (h, dh), "b", 0),
                (pre + ("attn", "bo"), (d,), "b", 0),
                (pre + ("attn", "rel_pos_h"), (rows, dh), "w", dh),
                (pre + ("attn", "rel_pos_w"), (rows, dh), "w", dh),
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


def rel_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, Dh): row [i, j] the table's entry for offset i - j,
    the table linearly interpolated first when it spans another size (as
    ``get_rel_pos`` does)."""
    rows = 2 * size - 1
    if rel_pos.shape[0] != rows:
        rel_pos = F.interpolate(rel_pos.t()[None], size=rows,
                                mode="linear")[0].t()
    pos = torch.arange(size, device=rel_pos.device)
    return rel_pos[pos[:, None] - pos[None, :] + size - 1]


def attention(a: dict, x: torch.Tensor, grid: int, matmul=mm,
              rel_pos: bool = True) -> torch.Tensor:
    """Attention over n grids of grid x grid tokens, x (n, grid^2, d)."""
    n, s, d = x.shape
    hh, dh = a["wq"].shape[1], a["wq"].shape[2]

    def heads(name):                           # -> (n, H, S, Dh)
        y = matmul(x, f32(a[f"w{name}"]).reshape(d, hh * dh)) \
            + f32(a[f"b{name}"]).reshape(-1)
        return y.reshape(n, s, hh, dh).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    scores = matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    if rel_pos:
        rh = rel_table(f32(a["rel_pos_h"]), grid)     # (gh, kh, Dh)
        rw = rel_table(f32(a["rel_pos_w"]), grid)     # (gw, kw, Dh)
        rq = q.reshape(n, hh, grid, grid, dh)
        rel_h = matmul(rq, rh.transpose(-1, -2))      # (n, H, gh, gw, kh)
        rel_w = matmul(rq.transpose(2, 3), rw.transpose(-1, -2)
                       ).transpose(2, 3)              # (n, H, gh, gw, kw)
        scores = (scores.reshape(n, hh, grid, grid, grid, grid)
                  + rel_h[..., :, None] + rel_w[..., None, :]
                  ).reshape(n, hh, s, s)
    ctx = matmul(torch.softmax(scores, dim=-1), v)    # (n, H, S, Dh)
    wo = f32(a["wo"])
    return (matmul(ctx.transpose(1, 2).reshape(n, s, hh * dh),
                   wo.reshape(hh * dh, -1)) + f32(a["bo"]))


def block(lp: dict, x: torch.Tensor, side: int, window: int, eps: float,
          matmul=mm, rel_pos: bool = True) -> torch.Tensor:
    """One block on one canvas, x (side^2, d); ``window`` 0: global."""
    d = x.shape[-1]
    h = layernorm(lp["ln1"], x, eps)
    if window:
        pad = -side % window
        n = (side + pad) // window
        g = F.pad(h.reshape(side, side, d), (0, 0, 0, pad, 0, pad))
        g = g.reshape(n, window, n, window, d).permute(0, 2, 1, 3, 4)
        out = attention(lp["attn"], g.reshape(n * n, window * window, d),
                        window, matmul, rel_pos)
        out = out.reshape(n, n, window, window, d).permute(0, 2, 1, 3, 4)
        h = out.reshape(n * window, n * window, d)[:side, :side].reshape(
            side * side, d)
    else:
        h = attention(lp["attn"], h[None], side, matmul, rel_pos)[0]
    x = x + h
    h = layernorm(lp["ln2"], x, eps)
    mlp = lp["mlp"]
    u = F.gelu(matmul(h, f32(mlp["fc1"]["kernel"])) + f32(mlp["fc1"]["bias"]))
    return (x + matmul(u, f32(mlp["fc2"]["kernel"]))
            + f32(mlp["fc2"]["bias"]))


def trunk_raw(tokens: torch.Tensor, weights: dict, side: int, eps: float,
              matmul=mm, windows: Optional[Sequence[int]] = None,
              rel_pos: bool = True) -> torch.Tensor:
    """:func:`detector_raw` with each block's window given (``windows``,
    0: global; by default read from the tables) and the relative-position
    terms on or off: the trunk as published, or a control that departs
    from it."""
    tp = weights["trunk"]
    head = weights["det_head"]
    if windows is None:
        windows = [(lp["attn"]["rel_pos_h"].shape[0] + 1) // 2
                   for lp in tp["layers"]]
        windows = [0 if w == side else w for w in windows]
    out = []
    with full_float32():
        for x in tokens:
            x = f32(x) + f32(tp["pos_embed"][0])
            for lp, window in zip(tp["layers"], windows):
                x = block(lp, x, side, window, eps, matmul, rel_pos)
            x = layernorm(tp["ln_f"], x, eps)
            out.append(matmul(x, f32(head["kernel"])) + f32(head["bias"]))
    return torch.stack(out).reshape(tokens.shape[0], side, side, 5)


@torch.no_grad()
def detector_raw(tokens: torch.Tensor, weights: dict, side: int,
                 eps: float = NORM_EPS, matmul=mm) -> torch.Tensor:
    """Embedded tokens (B, S, d) -> raw head (B, side, side, 5)."""
    return trunk_raw(tokens, weights, side, eps, matmul)


def flops_per_canvas(cfg: dict) -> float:
    """Multiply-adds x 2 of one canvas through the detector, counting the
    padded window tokens as the trunk computes them: the patch embed over
    every token; in a window block the Q/K/V/O projections and the
    relative-position terms over the padded grid, the two attention
    products within each window; in a global block the same over the
    grid (S x S products); the MLP over the grid; the 5-channel head.
    Norms, softmax, activations and the additions are not counted."""
    d, dff, p = cfg["d_model"], cfg["d_ff"], cfg["patch"]
    side = cfg["canvas"] // p
    s = side * side
    total = 2 * s * (p * p * 3) * d + 2 * s * d * 5
    for window in windows_of(cfg):
        grid = window or side
        n = -(-side // grid)
        padded = (n * grid) ** 2
        total += 2 * padded * d * d * 4                  # q, k, v, o
        total += 2 * 2 * n * n * (grid * grid) ** 2 * d  # q.k, p.v
        total += 2 * 2 * padded * grid * d               # q.Rh, q.Rw
        total += 2 * 2 * s * d * dff                     # the MLP
    return float(total)
