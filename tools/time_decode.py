#!/usr/bin/env python3
"""Time K7 (flash decode) of one checkout of the port on the card.

    python3 tools/time_decode.py [--root CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this repository),
builds its ``flash.cu`` with ``nvcc`` into ``CHECKOUT/build/kernels``,
prints the ``ptxas`` lines of its decode kernels, and at minitron-4b's
decode shape (24 query heads over 8 KV heads, head dim 128, bf16) times
``flash_decode`` three ways, each the median of 3 windows of 20 calls:

- ``ms_call``: calls back to back between two CUDA events (host time
  enters where a call's host work outlasts its device work);
- ``ms_device``: the same 20 calls captured in one CUDA graph, its
  replay timed between two CUDA events (no host work, but the gaps the
  card leaves between the graph's kernels);
- ``ms_profiler``: the device time of the kernels themselves, summed
  from ``torch.profiler`` over one window;

the same three with ``pos`` a 0-d int32 on the card (``tensor_pos_*``,
bit-equal to the host-int launch; a checkout whose K7 takes only a host
int has none); and the same three for SDPA over (B, Kv, pos+1, D)
copies of the cache (``sdpa_*``), the library yardstick.

One JSON line per shape.  Two checkouts are compared by running this
script once for each in one call on one card (parent, change, change,
parent).  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

SHAPES = ((2, 4096, 63), (2, 4096, 287), (2, 4096, 4095),
          (8, 32768, 32767))
H, KVH, D = 24, 8, 128


def events_ms(fn, iters: int, windows: int = 3) -> float:
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def timings(call, iters: int = 20) -> dict:
    for _ in range(3):
        call()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            call()

    out = {"ms_call": events_ms(window, iters)}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        window()
    graph.replay()
    torch.cuda.synchronize()
    out["ms_device"] = events_ms(graph.replay, iters)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out["ms_profiler"] = (sum(e.time_range.elapsed_us() for e in kernels)
                          / 1e3 / iters if kernels else None)
    out["kernels_per_call"] = len(kernels) / iters
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_decode: needs a CUDA card")
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
            entry = m.group(1) if "decode" in m.group(1) else None
        if entry and ("registers" in line or "spill" in line
                      or "entry function" in line):
            print(f"[{args.label}] ptxas: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, smax, pos in SHAPES:
        q = torch.randn((b, 1, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn((b, smax, KVH, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        got = ops.flash_decode(q, k, v, pos, impl="cuda")
        want = ops.flash_decode(q, k, v, pos, impl="torch")
        row = {"label": args.label, "b": b, "smax": smax, "pos": pos,
               "max_abs_err": (got.float() - want.float()).abs().max()
               .item(),
               "bound_ms": 2 * b * (pos + 1) * KVH * D * 2 / 3.35e12 * 1e3}
        row.update(timings(lambda: ops.flash_decode(q, k, v, pos,
                                                    impl="cuda")))
        if hasattr(flash, "decode_pos_arg"):     # K7 reads pos on the card
            dev = torch.tensor(pos, dtype=torch.int32, device="cuda")
            row["tensor_pos_bit_equal"] = torch.equal(
                ops.flash_decode(q, k, v, dev, impl="cuda"), got)
            row.update({f"tensor_pos_{key}": value for key, value in timings(
                lambda: ops.flash_decode(q, k, v, dev, impl="cuda")).items()})
        # the yardstick: SDPA over (B, Kv, pos+1, D) copies of the cache
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous()
                  for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row.update({f"sdpa_{key}": value for key, value in timings(
            lambda: sdpa(qt, kt, vt, enable_gqa=True)).items()})
        print(json.dumps(row), flush=True)
        del q, k, v, got, want, qt, kt, vt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
