"""deit-b [arXiv:2012.12877; paper] — DeiT-Base with distillation token.

Port of ``repro/configs/deit_b.py``: ``ARCH`` and its shape cells.  ViT-B/16's trunk with a distillation
token and a second head: 198 tokens at 224^2.
"""
from repro_torch.config import VISION_SHAPES, ViTConfig

ARCH = ViTConfig(
    name="deit-b",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    distill_token=True,
)

SHAPES = VISION_SHAPES
