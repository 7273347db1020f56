"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768, dense.
123B params: FSDP overlay (params + optimizer state sharded over "data"
as well as "model") and 4-way microbatch accumulation for train_4k.
Port of ``repro/configs/mistral_large_123b.py``.  246 GB in bf16 does not
fit one 80 GB card: the full width is planned and counted on the meta
device (``launch/dryrun.py``), and ``transformer.init_params`` refuses it
on one card (running it sharded over cards is ROADMAP item 17); the
reduced config (``configs/reduced.py``) runs anywhere.
"""
from repro_torch.config import LM_SHAPES, TransformerConfig
from repro_torch.configs import CellOverride

ARCH = TransformerConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=32_768,
    head_dim=128,
)

SHAPES = LM_SHAPES

OVERRIDES = {
    "train_4k": CellOverride(accum_steps=4, fsdp=True, act_seq=True,
                             remat_policy="minimal"),
    "prefill_32k": CellOverride(fsdp=True),
    # int8-resident weights (123B x 1B / 16 = 7.7 GiB a device): no
    # per-token FSDP parameter regathers
    "decode_32k": CellOverride(sequence_parallel=True, quant_weights=True),
    # batch 1: FSDP + int8 leave headroom beside the sequence-sharded
    # KV cache
    "long_500k": CellOverride(fsdp=True, sequence_parallel=True,
                              quant_weights=True),
}
