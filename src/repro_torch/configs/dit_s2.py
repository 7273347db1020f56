"""dit-s2 [arXiv:2212.09748; paper] — DiT-S/2: 12L d=384 6H, patch 2.

Port of ``repro/configs/dit_s2.py``: ``ARCH``, its shape cells and the
gen_1024 context-parallel override.  Heads of
64; 1,024 latent tokens at 512^2, 4,096 at 1024^2.
"""
from repro_torch.config import DIFFUSION_SHAPES, DiTConfig
from repro_torch.configs import CellOverride

ARCH = DiTConfig(
    name="dit-s2",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=384,
    n_heads=6,
)

SHAPES = DIFFUSION_SHAPES

# batch 4 < 16 data rows: token context-parallelism (see dit_xl2.py)
OVERRIDES = {
    "gen_1024": CellOverride(extra_rules={"seq": "data"}),
}
