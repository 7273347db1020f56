"""vit-s16 [arXiv:2010.11929; paper] — ViT-S/16.

Port of ``repro/configs/vit_s16.py``: ``ARCH`` only.  The registry's
``vit_s16`` detector runs on this trunk; the classifier's forward pass is
ROADMAP item 13, and the sharding cells (``SHAPES``) item 14.
"""
from repro_torch.config import ViTConfig

ARCH = ViTConfig(
    name="vit-s16",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=384,
    n_heads=6,
    d_ff=1536,
)
