"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
101.73 B parameters by the JAX package's count (11.13 B active a token):
203 GB in bf16 and about 102 GB in int8, more than one 80 GB card holds, so
the port runs it at reduced width only (its weights sharded over cards are
ROADMAP item 14).  Port of the ``ARCH`` of
``repro/configs/llama4_scout_17b_a16e.py``.
"""
from repro_torch.config import MoEConfig, TransformerConfig

ARCH = TransformerConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    head_dim=128,
    # group_size 128: MoE dispatch-einsum cost is ~linear in group size
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=0, d_ff_expert=8192,
                  capacity_factor=1.25, group_size=128),
)
