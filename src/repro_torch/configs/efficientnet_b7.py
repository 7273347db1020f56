"""efficientnet-b7 [arXiv:1905.11946; paper] — w2.0 d3.1 r600.

Port of ``repro/configs/efficientnet_b7.py``: ``ARCH``, its shape cells
and overrides.  The classifier runs through ``models/efficientnet.py``
(cuDNN convolutions, no hand kernel), and the registry's
``efficientnet_b7`` detector takes its weight economics from this net's
parameter count.
"""
from repro_torch.config import EfficientNetConfig, VISION_SHAPES
from repro_torch.configs import CellOverride

ARCH = EfficientNetConfig(
    name="efficientnet-b7",
    img_res=600,
    width_mult=2.0,
    depth_mult=3.1,
)

SHAPES = VISION_SHAPES

# Conv nets don't use tensor parallelism at 66M params: fold the "model"
# axis into data parallelism (batch shards over data x model) so every
# device does useful work instead of replicating convs 16x.
_DP_ALL = {"batch": ("data", "model", "pod")}
OVERRIDES = {s.name: CellOverride(extra_rules=_DP_ALL) for s in SHAPES}
