"""Stauffer-Grimson adaptive background mixture model (plain PyTorch).

Port of ``repro/core/gmm.py``.  Per-pixel K-component Gaussian mixture
over luminance; state tensors are (H, W, K): weight ``w``, mean ``mu``,
variance ``var``, float32 on the caller's device.  Ties keep the
reference's rules: first index in argmax/argmin and the ``kj < ki`` rank
tie-break.

:func:`update` is the plain version of K5, the hand-written GMM kernel in
``repro_torch/kernels/gmm``, which the edge pipeline runs on the card.
Every op rounds once, in float32, and the two sums over components are
written as left folds in index order (``(c0 + c1) + c2``): a reduction
kernel may add in another order (on the card, PyTorch's ``sum`` over a
3-wide last dimension can split it across lanes), and the fold keeps the
result the same on every device and bit-equal to the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GMMConfig:
    n_components: int = 3
    learning_rate: float = 0.05
    match_sigmas: float = 2.5      # match if |x-mu| < 2.5 sigma
    background_ratio: float = 0.8  # cumulative weight treated as background
    init_var: float = 0.04         # variance for new components ([0,1] pixels)
    min_var: float = 1e-4


def init_state(h: int, w: int, cfg: GMMConfig = GMMConfig(),
               device: DeviceLike = None) -> dict:
    """Fresh mixture state on ``device`` (``None`` -> ``cuda``)."""
    device = resolve_device(device)
    k = cfg.n_components
    wt = torch.zeros((h, w, k), dtype=torch.float32, device=device)
    wt[..., 0] = 1.0
    return {
        "w": wt,
        "mu": torch.zeros((h, w, k), dtype=torch.float32, device=device),
        "var": torch.full((h, w, k), cfg.init_var, dtype=torch.float32,
                          device=device),
    }


def update(state: dict, frame: torch.Tensor, cfg: GMMConfig = GMMConfig()
           ) -> Tuple[dict, torch.Tensor]:
    """One streaming update.  frame: (H, W) float32 in [0, 1] on the
    state's device.  Returns (new_state, foreground mask (H, W) bool)."""
    w, mu, var = state["w"], state["mu"], state["var"]
    k = cfg.n_components
    x = frame[..., None]                               # (H, W, 1)
    lr = cfg.learning_rate

    dist2 = torch.square(x - mu)                       # (H, W, K)
    matched = dist2 < (cfg.match_sigmas ** 2) * var
    any_match = matched.any(dim=-1)                    # (H, W)

    # among matched components pick the most dominant (max w/sigma)
    fitness = w / torch.sqrt(var)
    fit_masked = torch.where(matched, fitness, -torch.inf)
    best = fit_masked.argmax(dim=-1)                   # first max on ties
    onehot = (torch.nn.functional.one_hot(best, k).to(torch.float32)
              * any_match[..., None])

    # matched update
    w_new = (1 - lr) * w + lr * onehot
    rho = lr  # classic approximation of lr * N(x | mu, var)
    hit = onehot > 0
    mu_new = torch.where(hit, (1 - rho) * mu + rho * x, mu)
    var_new = torch.where(
        hit, torch.clamp_min((1 - rho) * var + rho * dist2, cfg.min_var), var)

    # no match: replace the weakest component with a fresh one at x
    weakest = w.argmin(dim=-1)
    replace = (torch.nn.functional.one_hot(weakest, k).bool()
               & ~any_match[..., None])
    w_new = torch.where(replace, lr, w_new)
    mu_new = torch.where(replace, x, mu_new)
    var_new = torch.where(replace, cfg.init_var, var_new)

    # renormalize weights
    w_new = w_new / _fold_sum(w_new)[..., None]

    # background = components whose strictly-fitter components weigh less
    # than the threshold (sort-free rank form, index tie-break)
    fit_new = w_new / torch.sqrt(var_new)
    ki = torch.arange(k, device=w.device)
    fitter = ((fit_new[..., None, :] > fit_new[..., :, None])
              | ((fit_new[..., None, :] == fit_new[..., :, None])
                 & (ki[None, :] < ki[:, None])))       # (H, W, K, K')
    cum_before = _fold_sum(torch.where(fitter, w_new[..., None, :], 0.0))
    is_bg = cum_before < cfg.background_ratio

    fg = ~(matched & is_bg).any(dim=-1)
    return {"w": w_new, "mu": mu_new, "var": var_new}, fg


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension as a left fold in index order."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def warmup(state: dict, frames: Iterable[torch.Tensor],
           cfg: GMMConfig = GMMConfig()) -> Tuple[dict, torch.Tensor]:
    """Run the model over a stack of frames (T, H, W) in order (the
    reference's ``lax.scan``).  Returns (final state, masks (T, H, W))."""
    masks = []
    for frame in frames:
        state, fg = update(state, frame, cfg)
        masks.append(fg)
    return state, torch.stack(masks)
