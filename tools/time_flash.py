#!/usr/bin/env python3
"""Time K6 (flash attention, bf16) of one checkout of the port on the card.

    python3 tools/time_flash.py [--root CHECKOUT] [--label NAME] [--shapes a,b]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this repository),
builds its ``flash.cu`` with ``nvcc`` into ``CHECKOUT/build/kernels``,
prints the ``ptxas`` lines of its bf16 K6 kernels, and at the main path's
K6 shapes (``SHAPES``: minitron-4b's prefill, ViT-B/16's serve_b128
layer, DiT-XL/2's gen_1024 layer, deepseek-moe-16b's prefill; or the
layout probes, ``PROBES``) times
``flash_attention`` as ``tools/time_decode.py`` times K7 (``ms_call``,
``ms_device`` from a CUDA graph of 20 calls, ``ms_profiler``), beside
SDPA on (B, H, S, D) copies (``sdpa_*``) and the bound: 4*B*S^2*H*D
operations (half that when causal) at 989 TFLOP/s, or q, k, v and the
output once each at 3.35 TB/s, whichever is longer.

One JSON line per shape, with the kernel's max abs error against its
plain version.  Two checkouts are compared by running this script once
for each in one call on one card (parent, change, change, parent).
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import torch

from time_decode import timings

#: name -> (B, S, H, KV heads, D, causal): the main path's K6 shapes
SHAPES = {
    "minitron-4b": (2, 4096, 24, 8, 128, True),
    "vit-b16": (128, 197, 12, 12, 64, False),
    "dit-xl2": (4, 4096, 16, 16, 72, False),
    "deepseek-moe-16b": (2, 4096, 16, 16, 128, True),
}
#: DiT-XL/2's layer at head dims 56 and 64: both laid out at 64, 56 on
#: 16-column 32-byte swizzled blocks, 64 on one 128-byte swizzled block,
#: so the pair reads what the narrow swizzle costs (``--shapes probes``)
PROBES = {
    "dit-xl2@d56": (4, 4096, 16, 16, 56, False),
    "dit-xl2@d64": (4, 4096, 16, 16, 64, False),
}
PEAK_FLOPS, HBM_BW = 989e12, 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of SHAPES or PROBES, or "
                         "'probes' for every probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash: needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.root) / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[{args.label}] card: {smi.stdout.strip()}", flush=True)
    flash.library()
    entry = None
    for line in _build.BUILDS[flash.LIBRARY]["log"].splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if "attention" in m.group(1) else None
        if entry and ("registers" in line or "spill" in line
                      or "entry function" in line or "C7515" in line):
            print(f"[{args.label}] ptxas: {line.strip()}")
    print(f"[{args.label}] build: "
          f"{_build.BUILDS[flash.LIBRARY]['seconds']:.1f} s", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = (list(PROBES) if args.shapes == "probes"
             else args.shapes.split(","))
    for name in names:
        b, s, h, kvh, d, causal = {**SHAPES, **PROBES}[name]
        q = torch.randn((b, s, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn((b, s, kvh, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        got = ops.flash_attention(q, k, v, causal=causal, impl="cuda")
        want = ops.flash_attention(q, k, v, causal=causal, impl="torch")
        ops_n = 4 * b * s * s * h * d // (2 if causal else 1)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        row = {"label": args.label, "model": name, "shape": [b, s, h, kvh, d],
               "causal": causal,
               "k6_kernel": flash.k6_kernel(q.dtype, d),
               "max_abs_err": (got.float() - want.float()).abs().max()
               .item(),
               "gflop": ops_n / 1e9,
               "bound_ms": max(ops_n / PEAK_FLOPS, nbytes / HBM_BW) * 1e3}
        del want
        row.update(timings(lambda: ops.flash_attention(q, k, v,
                                                       causal=causal,
                                                       impl="cuda")))
        row["tflops_device"] = ops_n / row["ms_device"] / 1e9
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row.update({f"sdpa_{key}": value for key, value in timings(
            lambda: sdpa(qt, kt, vt, is_causal=causal,
                         enable_gqa=kvh != h)).items()})
        print(json.dumps(row), flush=True)
        del q, k, v, got, qt, kt, vt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
