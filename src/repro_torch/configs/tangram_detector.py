"""The paper's own serving model: ViT-backbone detector on 1024^2 canvases.

~88M params (ViT-B trunk at patch 32 -> a 32x32 token grid), bf16.  Port
of ``repro/configs/tangram_detector.py``: ``ARCH`` and its shape cells
(``train_c32`` trains it on 32 canvases a step).
"""
from repro_torch.config import DetectorConfig, ShapeConfig

ARCH = DetectorConfig(
    name="tangram-detector",
    canvas=1024,
    patch=32,
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SHAPES = (
    ShapeConfig("serve_c8", "serve", img_res=1024, global_batch=8),
    ShapeConfig("serve_c1", "serve", img_res=1024, global_batch=1),
    ShapeConfig("train_c32", "train", img_res=1024, global_batch=32),
)
