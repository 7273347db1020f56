"""vit-s16 [arXiv:2010.11929; paper] — ViT-S/16.

Port of ``repro/configs/vit_s16.py``: ``ARCH`` and its shape cells.
The classifier runs through ``models/vit.py`` and the registry's
``vit_s16`` detector on this trunk.
"""
from repro_torch.config import VISION_SHAPES, ViTConfig

ARCH = ViTConfig(
    name="vit-s16",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=384,
    n_heads=6,
    d_ff=1536,
)

SHAPES = VISION_SHAPES
