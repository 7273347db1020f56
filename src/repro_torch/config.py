"""Config dataclasses for the decoder-only LM (dense or MoE), the ViT / DeiT
classifiers (and the detector's ViT trunk), DiT, EfficientNet, the
detector, a workload cell's shape, the card and the paper's Tangram
defaults.

Port of the parts of ``repro/config.py`` the ported paths need.  The
training fields ``remat`` and ``remat_policy`` keep the JAX defaults; the
JAX ``scan_layers`` is left out everywhere, because the port's layers are
a Python loop over a list (the converters unstack scanned JAX trees).
``dtype_of`` maps the configs' dtype names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeekMoE
    d_ff_expert: int = 0         # per-expert hidden size (0 -> use model d_ff)
    capacity_factor: float = 1.25
    group_size: int = 512        # tokens per dispatch group (GShard grouping)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only LM (dense or MoE): the JAX package's fields that the
    port reads.

    With ``moe`` set, each layer's MLP is a GShard mixture of experts
    (``models/moe.py``).  ``quant_weights`` keeps the layer
    and ``lm_head`` kernels int8 with per-output-channel float32 scales
    (embedding and norms stay in ``param_dtype``); ``quant_kv`` keeps the
    KV cache int8 with a float32 scale per position and KV head.  With
    ``remat`` each layer's activations are recomputed in the backward pass
    (``models/remat.py``): ``remat_policy="dots"`` keeps the weight
    products, ``"minimal"`` keeps only the layer's input.  The JAX
    ``scan_layers``, the TPU kernel's blocks (``flash_block_q`` /
    ``flash_block_kv``) and the sharded cache's write (``cache_update``)
    are left out: the port loops over its layers, its kernels pick their
    own tiles, and its decode writes the cache in place (the masked write
    of a sequence-sharded cache is ROADMAP item 17).
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "dots"
    fused_qkv: bool = False
    quant_weights: bool = False
    quant_kv: bool = False

    family: str = "lm"

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not "
                             f"a multiple of n_kv_heads {self.n_kv_heads}")

    def _attn_params(self) -> int:
        d = self.d_model
        return (d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d)

    def _embed_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + layers)."""
        d, L = self.d_model, self.n_layers
        if self.moe is not None:
            ff = self.moe.d_ff_expert or self.d_ff
            mlp = (self.moe.n_experts + self.moe.n_shared) * 3 * d * ff
            mlp += d * self.moe.n_experts  # router
        else:
            mlp = 3 * d * self.d_ff
        norms = 2 * d
        return (L * (self._attn_params() + mlp + norms)
                + self._embed_params() + d)

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE counts only the routed top-k)."""
        if self.moe is None:
            return self.n_params
        d, L = self.d_model, self.n_layers
        ff = self.moe.d_ff_expert or self.d_ff
        mlp = ((self.moe.top_k + self.moe.n_shared) * 3 * d * ff
               + d * self.moe.n_experts)
        return (L * (self._attn_params() + mlp + 2 * d)
                + self._embed_params() + d)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT / DeiT encoder classifier, and the detector's trunk.

    DeiT adds a distillation token and a second head (``distill_token``);
    ``patch_embed`` is ``"reshape"`` (patchify, then a dense) or
    ``"conv"`` (a strided conv stem, the same product on a
    (patch, patch, C, d) kernel).  ``fused_qkv`` keeps one ``wqkv``
    projection.  ``remat`` recomputes each layer in the backward pass,
    keeping its weight products (the JAX ``dots`` policy)."""

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False
    in_channels: int = 3
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    fused_qkv: bool = False
    # int8-resident encoder weights (per-output-channel scales); the
    # patch embed, position embedding and norms stay full precision
    quant_weights: bool = False
    patch_embed: str = "reshape"
    family: str = "vision"

    @property
    def n_tokens(self) -> int:
        side = self.img_res // self.patch
        return side * side + 1 + (1 if self.distill_token else 0)

    @property
    def n_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        patch_embed = self.in_channels * self.patch * self.patch * d + d
        head = d * self.n_classes
        return (self.n_layers * per_layer + patch_embed + head
                + self.n_tokens * d)

    @property
    def n_active_params(self) -> int:
        return self.n_params


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Diffusion transformer (DiT) with adaLN-zero conditioning.

    Operates on a VAE latent grid: latent side = img_res // 8, 4 channels,
    as in the DiT paper.  ``patch`` patchifies the latent grid.  ``remat``
    as for :class:`ViTConfig`.
    """

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    latent_channels: int = 4
    vae_factor: int = 8
    n_classes: int = 1000
    timestep_dim: int = 256
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    family: str = "diffusion"

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        res = img_res or self.img_res
        side = res // self.vae_factor // self.patch
        return side * side

    @property
    def n_params(self) -> int:
        d = self.d_model
        # attention + MLP + adaLN
        per_layer = 4 * d * d + 2 * d * self.d_ff + 6 * d * d + 4 * d
        io = self.latent_channels * self.patch**2 * d * 2
        cond = self.timestep_dim * d + d * d + self.n_classes * d
        return self.n_layers * per_layer + io + cond

    @property
    def n_active_params(self) -> int:
        return self.n_params


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """ViT-backbone anchor-free detector for the Tangram pipeline;
    ``remat`` as for :class:`ViTConfig` (off, as in the JAX config)."""

    name: str
    canvas: int = 1024
    patch: int = 32
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    # int8-resident trunk weights (per-output-channel scales); the patch
    # embed, head and norms stay full precision
    quant_weights: bool = False

    @property
    def n_tokens(self) -> int:
        side = self.canvas // self.patch
        return side * side

    @property
    def n_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        return (self.n_layers * per_layer + 3 * self.patch**2 * d + d * 5
                + self.n_tokens * d)

    @property
    def n_active_params(self) -> int:
        return self.n_params


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    """EfficientNet with compound scaling (B0 base scaled by width/depth).
    ``dropout`` is the JAX config's field; like the reference's forward
    pass, the port's applies none."""

    name: str
    img_res: int
    width_mult: float
    depth_mult: float
    n_classes: int = 1000
    dropout: float = 0.5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    family: str = "vision"

    # B0 stage template: (expand, channels, repeats, stride, kernel)
    STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
        (1, 16, 1, 1, 3),
        (6, 24, 2, 2, 3),
        (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3),
        (6, 112, 3, 1, 5),
        (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3),
    )
    stem_channels: int = 32
    head_channels: int = 1280

    def scaled_channels(self, c: int) -> int:
        c = c * self.width_mult
        new_c = max(8, int(c + 4) // 8 * 8)
        if new_c < 0.9 * c:
            new_c += 8
        return new_c

    def scaled_repeats(self, r: int) -> int:
        return int(math.ceil(self.depth_mult * r))

    @property
    def n_params(self) -> int:
        """Exact, from the parameter spec tree."""
        from repro_torch.models import efficientnet
        return efficientnet.count_params(self)

    @property
    def n_active_params(self) -> int:
        return self.n_params


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One workload cell: what step runs and at what sizes."""

    name: str
    kind: str               # train | prefill | decode | gen | cls | serve
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0          # diffusion sampler steps

    @property
    def is_train(self) -> bool:
        return self.kind in ("train", "cls")

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeConfig("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
    ShapeConfig("decode_32k", "decode", seq_len=32_768, global_batch=128),
    ShapeConfig("long_500k", "decode", seq_len=524_288, global_batch=1),
)

DIFFUSION_SHAPES = (
    ShapeConfig("train_256", "train", img_res=256, global_batch=256,
                steps=1000),
    ShapeConfig("gen_1024", "gen", img_res=1024, global_batch=4, steps=50),
    ShapeConfig("gen_fast", "gen", img_res=512, global_batch=16, steps=4),
    ShapeConfig("train_1024", "train", img_res=1024, global_batch=32,
                steps=1000),
)

VISION_SHAPES = (
    ShapeConfig("cls_224", "cls", img_res=224, global_batch=256),
    ShapeConfig("cls_384", "cls", img_res=384, global_batch=64),
    ShapeConfig("serve_b1", "serve", img_res=224, global_batch=1),
    ShapeConfig("serve_b128", "serve", img_res=224, global_batch=128),
)


def shapes_for(model_cfg) -> Tuple[ShapeConfig, ...]:
    fam = model_cfg.family
    if fam == "lm":
        return LM_SHAPES
    if fam == "diffusion":
        return DIFFUSION_SHAPES
    if fam in ("vision", "detector"):
        return VISION_SHAPES
    raise ValueError(f"unknown family {fam}")


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """NVIDIA H100 SXM data-sheet constants (dense, no sparsity, at the
    700 W power limit) used by the analytical latency model and the
    kernels' byte bounds.  A card set below 700 W runs slower."""

    peak_flops: float = 989e12       # bf16 tensor-core FLOP/s per card
    hbm_bw: float = 3.35e12          # HBM3 bytes/s per card
    nvlink_bw: float = 450e9         # NVLink bytes/s each way per card
    hbm_bytes: int = 80 * 1024**3    # device memory per card


@dataclasses.dataclass(frozen=True)
class TangramConfig:
    """Paper-facing knobs (Sections III-IV defaults)."""

    canvas_m: int = 1024             # canvas height M
    canvas_n: int = 1024             # canvas width N
    zone_x: int = 4                  # partition grid X
    zone_y: int = 4                  # partition grid Y
    slo_s: float = 1.0               # default SLO
    slack_sigmas: float = 3.0        # T_slack = mu + 3 sigma
    max_canvases_per_batch: int = 8  # from function memory (Eq. 5)
    # Alibaba FC function spec from Section V-A
    n_vcpu: int = 2
    mem_gb: float = 4.0
    gpu_mem_gb: float = 6.0
    model_mem_gb: float = 1.5        # tau: model residency in accelerator mem
    canvas_mem_gb: float = 0.5       # w: activation memory per canvas


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
