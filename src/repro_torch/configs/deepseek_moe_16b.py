"""deepseek-moe-16b [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed top-6, fine-grained experts (d_ff_expert=1408).
16.88 B parameters (2.83 B active a token), 33.76 GB in bf16, which one
80 GB H100 holds.  Port of ``repro/configs/deepseek_moe_16b.py``:
``ARCH``, its shape cells and overrides.
"""
from repro_torch.config import LM_SHAPES, MoEConfig, TransformerConfig
from repro_torch.configs import CellOverride

ARCH = TransformerConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  capacity_factor=1.25, group_size=512),
)

SHAPES = LM_SHAPES

OVERRIDES = {
    "train_4k": CellOverride(accum_steps=2, fsdp=True, act_seq=True,
                             remat_policy="minimal"),
    "prefill_32k": CellOverride(fsdp=True),
}
