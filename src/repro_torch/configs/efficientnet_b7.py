"""efficientnet-b7 [arXiv:1905.11946; paper] — w2.0 d3.1 r600.

Port of ``repro/configs/efficientnet_b7.py``: ``ARCH`` only.  The
classifier runs through ``models/efficientnet.py`` (cuDNN convolutions,
no hand kernel), and the registry's ``efficientnet_b7`` detector takes
its weight economics from this net's parameter count; the sharding cells
(``SHAPES``, ``OVERRIDES``) are ROADMAP item 14.
"""
from repro_torch.config import EfficientNetConfig

ARCH = EfficientNetConfig(
    name="efficientnet-b7",
    img_res=600,
    width_mult=2.0,
    depth_mult=3.1,
)
