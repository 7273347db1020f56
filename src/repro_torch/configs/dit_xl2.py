"""dit-xl2 [arXiv:2212.09748; paper] — DiT-XL/2: 28L d=1152 16H, patch 2.

Port of ``repro/configs/dit_xl2.py``: ``ARCH``, its shape cells and
overrides.  Heads of 72, a head dim K6 takes through
its ``mma.sync`` path; 671.8 M parameters, 1,024 latent tokens at 512^2,
4,096 at 1024^2.
"""
from repro_torch.config import DIFFUSION_SHAPES, DiTConfig
from repro_torch.configs import CellOverride

ARCH = DiTConfig(
    name="dit-xl2",
    img_res=256,
    patch=2,
    n_layers=28,
    d_model=1152,
    n_heads=16,
)

SHAPES = DIFFUSION_SHAPES

OVERRIDES = {
    "train_1024": CellOverride(accum_steps=1),
    # batch 4 < 16 data rows: shard the 4096 latent tokens over the idle
    # data axis (context parallelism)
    "gen_1024": CellOverride(extra_rules={"seq": "data"}),
}
