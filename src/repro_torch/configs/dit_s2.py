"""dit-s2 [arXiv:2212.09748; paper] — DiT-S/2: 12L d=384 6H, patch 2.

Port of ``repro/configs/dit_s2.py``: ``ARCH`` (the sharding cells and
the gen_1024 context-parallel override are ROADMAP item 14).  Heads of
64; 1,024 latent tokens at 512^2, 4,096 at 1024^2.
"""
from repro_torch.config import DiTConfig

ARCH = DiTConfig(
    name="dit-s2",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=384,
    n_heads=6,
)
