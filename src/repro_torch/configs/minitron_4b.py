"""minitron-4b [arXiv:2407.14679] — pruned Nemotron, dense decoder-only LM.

32 layers, d_model 3072, 24 query heads over 8 KV heads (GQA, head_dim
128), d_ff 9216, vocab 256000, untied embeddings, bf16: 5.10 B parameters,
10.19 GB in bf16, which one 80 GB H100 holds.  Port of
``repro/configs/minitron_4b.py``: ``ARCH``, its shape cells and
overrides.  24 heads / 8 KV heads do not divide the 16-way model axis, so
the attention projections stay replicated there; the MLP (9216) and the
vocabulary (256000) shard on "model".
"""
from repro_torch.config import LM_SHAPES, TransformerConfig
from repro_torch.configs import CellOverride

ARCH = TransformerConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    head_dim=128,
)

SHAPES = LM_SHAPES

OVERRIDES = {
    "train_4k": CellOverride(accum_steps=2, fsdp=True, act_seq=True,
                             remat_policy="minimal"),
    "decode_32k": CellOverride(sequence_parallel=True),
    "long_500k": CellOverride(sequence_parallel=True),
}
