"""ViTDet-L: the plain ViT-L backbone of Li, Mao, Girshick, He,
"Exploring Plain Vision Transformer Backbones for Object Detection"
(arXiv:2203.16527), as Detectron2's
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py`` sets it, at
the paper's 1024x1024 input: patch 16 (a 64x64 grid), d 1024, 24 blocks
of 16 heads of 64, MLP 4096 with the exact (erf) GELU, q/k/v and
output-projection biases, LayerNorm eps 1e-6, 14x14 windowed attention
but in blocks 5, 11, 17 and 23 (global), and decomposed relative
positions in every block.  The registry's ``vitdet_l`` serves it, in
bf16, with the system's final norm and 5-channel head in place of the
feature pyramid and the Mask R-CNN heads
(``models/vitdet_reference.py`` lists every departure).
"""
from repro_torch.config import DetectorConfig

ARCH = DetectorConfig(
    name="vitdet-l",
    canvas=1024,
    patch=16,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    window=14,
    global_every=6,
    rel_pos=True,
    attn_bias=True,
    gelu="erf",
)
