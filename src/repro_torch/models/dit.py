"""Diffusion Transformer (DiT) with adaLN-zero conditioning.

Port of ``repro/models/dit.py``.  The model runs on a VAE latent grid
(img_res / 8, 4 channels) patchified with ``cfg.patch`` (DiT-*/2: patch
2), the compute shape of the paper (arXiv:2212.09748).  No VAE is
included: latents are the inputs.  Parameters are nested dicts of tensors
in the JAX package's layouts, the stacked ``layers`` axis unstacked into a
list:

    {"patch_embed": {kernel (p*p*C, d), bias}, "t_mlp1": {kernel (256, d),
     bias}, "t_mlp2": {kernel (d, d), bias}, "label_embed": (n_classes + 1,
     d) (the last row is the classifier-free-guidance null class),
     "layers": [{"attn": {wq, wk, wv, wo}, "mlp": {"fc1", "fc2"},
                 "ada": {kernel (d, 6d), bias}}, ...],
     "final_ada": {kernel (d, 2d), bias}, "final_proj": {kernel (d,
     p*p*C), bias}}

``ada``, ``final_ada`` and ``final_proj`` start at zero (adaLN-zero), so a
freshly drawn model predicts eps = 0.  The attention is
``attention.encoder_attention``: ``impl="xla"`` (the default, as in the
JAX package) is plain attention, ``impl="flash"`` runs K6 non-causal on a
CUDA tensor.  ``diffusion_loss`` carries gradients; with ``cfg.remat``
each layer is recomputed in the backward pass, its weight products kept
(``models/remat.py``).  ``ddim_sample`` runs its steps as a Python loop
where the JAX package scans.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from repro_torch.config import DiTConfig, dtype_of
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models import layers, remat
from repro_torch.models.vit import unstack_layers
from repro_torch.param import convert_like, spec
from repro_torch.param import init_params as init_tree

T_MAX = 1000  # diffusion timestep range


# ------------------------------------------------------------ parameters ----

def _layer_specs(cfg: DiTConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    return {
        "attn": attn.gqa_specs(d, cfg.n_heads, cfg.n_heads,
                               d // cfg.n_heads, dtype),
        "mlp": layers.gelu_mlp_specs(d, cfg.d_ff, dtype),
        # adaLN-zero: 6*d modulation from the conditioning, zero-init
        "ada": layers.dense_specs(d, 6 * d, dtype=dtype, bias=True,
                                  zero_init=True),
    }


def param_specs(cfg: DiTConfig) -> dict:
    """The model's :class:`~repro_torch.param.ParamSpec` tree, with the
    JAX package's shapes and init rules."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    patch_dim = cfg.latent_channels * cfg.patch * cfg.patch
    return {
        "patch_embed": layers.dense_specs(patch_dim, d, dtype=dtype,
                                          bias=True),
        "t_mlp1": layers.dense_specs(cfg.timestep_dim, d, dtype=dtype,
                                     bias=True),
        "t_mlp2": layers.dense_specs(d, d, dtype=dtype, bias=True),
        "label_embed": spec((cfg.n_classes + 1, d), dtype=dtype,
                            init="embed"),
        "layers": [_layer_specs(cfg, dtype)] * cfg.n_layers,
        "final_ada": layers.dense_specs(d, 2 * d, dtype=dtype, bias=True,
                                        zero_init=True),
        "final_proj": layers.dense_specs(d, patch_dim, dtype=dtype,
                                         bias=True, zero_init=True),
    }


def init_params(cfg: DiTConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the JAX package's init rules (the adaLN and
    output projections zero), drawn from ``generator`` on ``device``."""
    return init_tree(param_specs(cfg), generator, device)


def convert_params(tree: dict, cfg: DiTConfig,
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's DiT parameters (nested dicts of arrays) -> the
    port's tree on ``device``: the stacked layers unstacked into a list,
    each leaf in its spec's dtype (bf16 keeps its bits). ``dtype``, when
    given, is every leaf's dtype instead (an optimizer state's float32
    moments, which have the parameters' tree)."""
    out = dict(tree)
    out["layers"] = unstack_layers(tree["layers"], cfg.n_layers)
    return convert_like(out, param_specs(cfg), device, dtype)


# ------------------------------------------------------------ embeddings ----

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding.  t: (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify_latent(z: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C)."""
    b, hh, ww, c = z.shape
    h, w = hh // patch, ww // patch
    x = z.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def unpatchify_latent(x: torch.Tensor, patch: int, side: int,
                      channels: int) -> torch.Tensor:
    """(B, side*side, patch*patch*C) -> (B, side*patch, side*patch, C)."""
    b = x.shape[0]
    x = x.reshape(b, side, side, patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, side * patch, side * patch, channels)


# ----------------------------------------------------------------- model ----

def _block(cfg: DiTConfig, lp: dict, x: torch.Tensor, cond: torch.Tensor,
           impl: str) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    mod = layers.dense(lp["ada"], cond, cdt)                    # (B, 6d)
    s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
    h = layers.modulated_layernorm(x, s1, sc1, cfg.norm_eps, cdt)
    h = attn.encoder_attention(lp["attn"], h, compute_dtype=cdt, impl=impl)
    x = x + g1[:, None, :] * h
    h = layers.modulated_layernorm(x, s2, sc2, cfg.norm_eps, cdt)
    h = layers.gelu_mlp(lp["mlp"], h, cdt)
    return x + g2[:, None, :] * h


def forward(cfg: DiTConfig, params: dict, latents: torch.Tensor,
            t: torch.Tensor, labels: torch.Tensor, *,
            impl: str = "xla") -> torch.Tensor:
    """latents (B, Hl, Wl, C), timesteps t (B,), class labels (B,) -> the
    predicted noise, (B, Hl, Wl, C) in the compute dtype.  Labels outside
    [0, n_classes] clamp (``jnp.take(mode="clip")``)."""
    cdt = dtype_of(cfg.compute_dtype)
    side = latents.shape[1] // cfg.patch

    x = layers.dense(params["patch_embed"],
                     patchify_latent(latents.to(cdt), cfg.patch), cdt)
    temb = timestep_embedding(t, cfg.timestep_dim)
    cond = layers.dense(params["t_mlp2"], layers.silu(
        layers.dense(params["t_mlp1"], temb.to(cdt), cdt)), cdt)
    table = params["label_embed"]
    ids = labels.to(torch.int64).clamp(0, table.shape[0] - 1)
    cond = layers.silu(cond + table[ids].to(cdt))               # (B, d)

    for lp in params["layers"]:
        x = remat.run(_block, cfg, lp, x, cond, impl, remat=cfg.remat)

    sf, scf = torch.chunk(layers.dense(params["final_ada"], cond, cdt), 2,
                          dim=-1)
    x = layers.modulated_layernorm(x, sf, scf, cfg.norm_eps, cdt)
    x = layers.dense(params["final_proj"], x, cdt)
    return unpatchify_latent(x, cfg.patch, side, cfg.latent_channels)


# -------------------------------------------------------------- schedule ----

def linspace_f32(start: float, stop: float, num: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA computes it on
    the CPU: start * (1 - s_i) + stop * s_i with s_i = i * (1 / (num -
    1)), every op a float32 rounding (XLA turns the division by the
    constant into a product by its reciprocal), the last element ``stop``
    itself.  Its integer truncation equals JAX's DDIM grid for every
    ``num`` up to 354; ``torch.linspace`` steps from ``start`` by a float32
    delta and truncates to other integers (at num 4 from 999: 666 where
    JAX gives 665)."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start_t[None]
    recip = 1 / torch.tensor(num - 1, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) * recip
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


def linear_alphas(n_steps: int = T_MAX,
                  device: DeviceLike = None) -> torch.Tensor:
    """The cumulative products of 1 - beta over the linear beta schedule
    1e-4 .. 0.02, float32."""
    betas = linspace_f32(1e-4, 0.02, n_steps, device)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(n_steps: int) -> List[int]:
    """The sampler's timesteps, T_MAX - 1 down to 0: the JAX package's
    ``jnp.linspace(T_MAX - 1, 0, n_steps).astype(int32)``."""
    return [int(v) for v in linspace_f32(T_MAX - 1, 0, n_steps).to(
        torch.int32)]


def diffusion_loss(cfg: DiTConfig, params: dict, batch: dict, *,
                   impl: str = "xla") -> torch.Tensor:
    """batch: {latents (B, H, W, C) clean, t (B,) int, noise (B, H, W, C),
    labels (B,)} -> the float32 epsilon-prediction MSE at the given
    timesteps."""
    alphas = linear_alphas(device=batch["latents"].device)
    a = alphas[batch["t"].to(torch.int64)][:, None, None, None]
    x0 = batch["latents"].to(torch.float32)
    eps = batch["noise"].to(torch.float32)
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    eps_hat = forward(cfg, params, xt, batch["t"], batch["labels"],
                      impl=impl).to(torch.float32)
    return (eps_hat - eps).square().mean()


@torch.inference_mode()
def ddim_sample(cfg: DiTConfig, params: dict, noise: torch.Tensor,
                labels: torch.Tensor, *, n_steps: int,
                impl: str = "xla") -> torch.Tensor:
    """DDIM sampler: ``n_steps`` model forwards from the gaussian latents
    ``noise`` (B, Hl, Wl, C) -> denoised float32 latents."""
    alphas = linear_alphas(device=noise.device)
    ts = ddim_timesteps(n_steps)
    x = noise.to(torch.float32)
    for i, t in enumerate(ts):
        last = i + 1 == n_steps
        a_t = alphas[t]
        a_p = (torch.ones((), dtype=torch.float32, device=x.device) if last
               else alphas[ts[i + 1]])
        tb = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        eps = forward(cfg, params, x, tb, labels, impl=impl).to(
            torch.float32)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps
    return x
