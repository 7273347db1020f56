"""minitron-4b [arXiv:2407.14679] — pruned Nemotron, dense decoder-only LM.

32 layers, d_model 3072, 24 query heads over 8 KV heads (GQA, head_dim
128), d_ff 9216, vocab 256000, untied embeddings, bf16: 5.10 B parameters,
10.19 GB in bf16, which one 80 GB H100 holds.  Port of the ``ARCH`` of
``repro/configs/minitron_4b.py`` (its shape cells and sharding overrides
wait for the benchmark and ROADMAP item 14).
"""
from repro_torch.config import TransformerConfig

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
