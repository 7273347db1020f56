"""The plain reference of the ViTDet trunk and the detector head, in
float32 PyTorch with TF32 off: no kernel of the port, no batching of
canvases, no cache.

It follows Detectron2's ``modeling/backbone/vit.py`` (``Block``,
``Attention``, ``window_partition`` / ``window_unpartition``,
``get_rel_pos``, ``add_decomposed_rel_pos``) on the port's parameter
tree (``models/detector.param_specs``) and its ``DetectorConfig``.
Departures from the published model:

- the absolute position embedding is held at the canvas's grid (64x64 at
  1024^2): ViTDet interpolates a 14x14 pretraining table at every
  forward, which at a fixed input is one fixed table;
- the relative-position tables are held at the grid each block attends
  over (its window, or the whole grid in a global block), so
  ``get_rel_pos`` interpolates only when asked to run a block at
  another size (the all-global control);
- the system's final LayerNorm and 5-channel per-token head take the
  place of the simple feature pyramid and the Mask R-CNN heads, as for
  every detector of the registry;
- drop-path is off (inference), and the tokens come already embedded
  (K4's contract: the patch embed of the canvas).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_float32():
    """Float32 products as float32: TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), f32(p["scale"]), f32(p["bias"]),
                        eps)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B * nh * nw, window, window, C) and the padded
    (Hp, Wp): the bottom and right padded with zeros."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window, window, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw,
                       hw) -> torch.Tensor:
    """The windows back on the padded grid, cropped to (B, H, W, C)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """The table's rows by relative offset: (q_size, k_size, C), the
    table linearly interpolated first when it spans another size."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear").reshape(
                -1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor,
                           rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           q_size, k_size) -> torch.Tensor:
    """attn (B, q_h * q_w, k_h * k_w) plus ``q . Rh`` and ``q . Rw``, q
    (B, q_h * q_w, C) unscaled."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b, q_h * q_w, k_h * k_w)
    return attn


def attention(p: dict, x: torch.Tensor, use_rel_pos: bool = True
              ) -> torch.Tensor:
    """Detectron2's ``Attention`` on x (B, H, W, dim): q/k/v with
    biases, scaled q . k, the relative-position terms, softmax, the
    output projection with its bias."""
    b, h, w, dim = x.shape
    n_heads, head_dim = p["wq"].shape[1], p["wq"].shape[2]
    tokens = x.reshape(b, h * w, dim)

    def proj(name):
        y = tokens @ f32(p[f"w{name}"]).reshape(dim, n_heads * head_dim)
        y = y + f32(p[f"b{name}"]).reshape(-1)
        return y.reshape(b, h * w, n_heads, head_dim).permute(
            0, 2, 1, 3).reshape(b * n_heads, h * w, head_dim)

    q, k, v = proj("q"), proj("k"), proj("v")
    attn = (q * (1.0 / math.sqrt(head_dim))) @ k.transpose(-2, -1)
    if use_rel_pos:
        attn = add_decomposed_rel_pos(attn, q, f32(p["rel_pos_h"]),
                                      f32(p["rel_pos_w"]), (h, w), (h, w))
    attn = attn.softmax(dim=-1)
    ctx = (attn @ v).view(b, n_heads, h, w, head_dim).permute(
        0, 2, 3, 1, 4).reshape(b, h, w, n_heads * head_dim)
    wo = f32(p["wo"]).reshape(n_heads * head_dim, -1)
    return ctx @ wo + f32(p["bo"])


def block(lp: dict, x: torch.Tensor, window: int, eps: float,
          use_rel_pos: bool = True) -> torch.Tensor:
    """Detectron2's ``Block`` on x (B, H, W, dim): the window partitioned
    after ``norm1`` (``window`` 0: global), the exact GELU MLP."""
    shortcut = x
    x = layer_norm(lp["ln1"], x, eps)
    if window > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
    x = attention(lp["attn"], x, use_rel_pos)
    if window > 0:
        x = window_unpartition(x, window, pad_hw, (h, w))
    x = shortcut + x
    mlp = lp["mlp"]
    y = layer_norm(lp["ln2"], x, eps)
    y = F.gelu(y @ f32(mlp["fc1"]["kernel"]) + f32(mlp["fc1"]["bias"]))
    return x + y @ f32(mlp["fc2"]["kernel"]) + f32(mlp["fc2"]["bias"])


@torch.no_grad()
def forward_tokens(cfg, params: dict, tokens: torch.Tensor,
                   windows: Optional[Sequence[int]] = None,
                   use_rel_pos: bool = True, eps: float = 1e-6
                   ) -> torch.Tensor:
    """Embedded tokens (B, side * side, d) -> raw head (B, side, side, 5),
    one canvas at a time.  ``windows`` (each block's window side, 0:
    global) defaults to ``cfg.block_window``; ``use_rel_pos`` False
    leaves the relative-position terms out."""
    side = cfg.canvas // cfg.patch
    if windows is None:
        windows = [cfg.block_window(i) for i in range(cfg.n_layers)]
    tp = params["trunk"]
    head = params["det_head"]
    out = []
    with full_float32():
        for x in tokens:
            x = (f32(x) + f32(tp["pos_embed"][0])).reshape(1, side, side, -1)
            for lp, window in zip(tp["layers"], windows):
                x = block(lp, x, window, eps, use_rel_pos)
            x = layer_norm(tp["ln_f"], x.reshape(side * side, -1), eps)
            out.append(x @ f32(head["kernel"]) + f32(head["bias"]))
    return torch.stack(out).reshape(tokens.shape[0], side, side, 5)
