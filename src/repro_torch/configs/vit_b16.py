"""vit-b16 [arXiv:2010.11929; paper] — ViT-B/16.

Port of ``repro/configs/vit_b16.py``: ``ARCH`` and its shape cells.  12 layers, d 768, 12 heads of 64, 197
tokens at 224^2; 86.5 M parameters (``n_params``).
"""
from repro_torch.config import VISION_SHAPES, ViTConfig

ARCH = ViTConfig(
    name="vit-b16",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
)

SHAPES = VISION_SHAPES
