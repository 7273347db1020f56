"""Tangram's idea applied to LM serving, on the PyTorch + CUDA port:
SLO-aware sequence packing.

Variable-length prefill requests are packed into fixed (rows x seq_len)
buffers with the same best-fit rule and the *same* SLO-aware invoker as
the vision canvases, then served by a small decoder LM with the
flash-attention kernel's segment masking so packed requests never attend
across boundaries.  The counterpart of
``examples/lm_sequence_packing.py``, with its sizes and printed lines; on
the card attention runs the hand-written K6 kernel.

    PYTHONPATH=src python examples/torch_lm_sequence_packing.py      # card
    PYTHONPATH=src python examples/torch_lm_sequence_packing.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import param as param_lib
from repro_torch.config import TransformerConfig
from repro_torch.core.latency import LatencyTable
from repro_torch.core.sequence_packing import Request, SequencePacker, pack
from repro_torch.device import resolve_device
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import transformer as tfm

SEQ = 512
CFG = TransformerConfig(name="packlm", n_layers=2, d_model=128, n_heads=4,
                        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
                        param_dtype="float32", compute_dtype="float32",
                        remat=False)


def init_params(device) -> dict:
    """The LM's weights, drawn on the host from a generator seeded with 0
    (so they are the same on every device) and moved to ``device``."""
    host = tfm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return param_lib.map_tree(lambda t: t.to(device), host)


def serve_row(params: dict, tokens: torch.Tensor, seg: torch.Tensor,
              impl=None):
    """One packed row through the LM, then the flash kernel with the
    row's block-diagonal segment mask: (hidden (1, SEQ, d), attention
    output (1, SEQ, 4, 32)).  ``impl`` as in ``attn_ops.flash_attention``
    (``None``: K6 on the card, its plain version on the CPU)."""
    with torch.no_grad():
        h, _ = tfm.forward(CFG, params, tokens, impl=impl)
        q = torch.ones((1, SEQ, 4, 32), dtype=torch.float32,
                       device=tokens.device)
        # the kernel takes contiguous k / v; the JAX entry's block_q,
        # block_kv and interpret size and emulate the TPU grid and have
        # no counterpart here
        kv = q[:, :, :2].contiguous()
        out = attn_ops.flash_attention(q, kv, kv, causal=True,
                                       segment_ids=seg, impl=impl)
    return h, out


def main(argv=None, params=None):
    """Run the example; ``params`` replaces the seeded weights (a tree on
    the device, e.g. the JAX example's through ``convert_params``).
    Returns the served row's inputs and outputs."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # a burst of requests with zipf-ish lengths and 300 ms SLOs
    reqs = [Request(int(np.clip(rng.lognormal(4.5, 0.8), 8, SEQ)),
                    t_gen=float(i) * 0.01, slo=0.3, request_id=i)
            for i in range(24)]
    rows = pack(reqs, SEQ)
    eff = sum(r.used for r in rows) / (len(rows) * SEQ)
    print(f"packed {len(reqs)} requests -> {len(rows)} rows "
          f"(efficiency {eff:.2f}; unpacked would need {len(reqs)} rows)")

    # SLO-aware invoker over rows (identical control path to canvases)
    table = LatencyTable({b: (0.02 * b, 0.002) for b in range(1, 65)})
    packer = SequencePacker(SEQ, table)
    fired = []
    for r in reqs:
        fired += packer.on_request(r.t_gen, r)
        while (inv := packer.poll(r.t_gen)) is not None:
            fired.append(inv)
    if (final := packer.invoker.flush(1.0)) is not None:
        fired.append(final)
    print(f"invoker dispatched {len(fired)} batched prefills "
          f"(reasons: {[f.reason for f in fired]})")

    # serve one packed row through a real model with segment masking
    if params is None:
        params = init_params(device)
    tokens = torch.from_numpy(
        rng.integers(0, 512, (1, SEQ)).astype(np.int32)).to(device)
    seg = np.zeros((1, SEQ), np.int32)
    for j, (_, s, e) in enumerate(rows[0].spans):
        seg[0, s:e] = j + 1
    seg = torch.from_numpy(seg).to(device)

    h, out = serve_row(params, tokens, seg)
    print(f"packed-forward OK: hidden {tuple(h.shape)}, "
          f"segment-masked flash attention {tuple(out.shape)}")
    return {"params": params, "tokens": tokens, "segment_ids": seg,
            "hidden": h, "attention": out}


if __name__ == "__main__":
    main()
