#!/usr/bin/env python3
"""Time K1 (stitch) and K3 (decode->gather) of one checkout of the port on
the card.

    python3 tools/time_stitch.py [--root CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this repository),
builds its ``stitch.cu`` and ``fused_embed.cu`` with ``nvcc`` into
``CHECKOUT/build/kernels``, prints the ``ptxas`` lines of their K1 and K3
kernels, and times both through the checkout's own entry points at the
serving trace's largest invocation: 73 patches packed by the checkout's
packer onto B=3 canvases of 1024^2 (K=64 records a canvas, slots 128 x 256
x 512 x 3 float32, 1.84 M pixels placed), and a float32 raw head of 32^2
cells a canvas at patch 32 for K3.  Each kernel gets, as the median of 3
windows of 20 calls:

- ``ms_call``: calls back to back between two CUDA events (host time
  enters where a call's host work outlasts its device work);
- ``ms_device``: the same 20 calls captured in one CUDA graph, its replay
  timed between two CUDA events (the card alone, with the gaps between
  the graph's kernels);
- ``ms_profiler``: the device activities ``torch.profiler`` records over
  one window, summed, and ``kernels_per_call``, their count a call
  (``tools/time_decode.timings``);

beside its byte bound at 3.35 TB/s, and ``launch_floor_ms``: one
``fill_`` of a one-element tensor in the same graph harness, the least a
launch costs the card.  One JSON line per kernel.  Two checkouts are
compared by running this script once for each in one call on one card
(parent, change, change, parent).  Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from time_decode import timings  # the same three timings as K7's tool

CANVAS, PATCH = 1024, 32
HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_stitch: needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(args.root) / "src"))
    from repro_torch.core.partitioning import Patch
    from repro_torch.core.stitching import build_batch_plan, stitch
    from repro_torch.kernels import _build
    from repro_torch.kernels.stitch import fused_embed, ops
    from repro_torch.kernels.stitch import stitch as stitch_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[{args.label}] card: {smi.stdout.strip()}", flush=True)
    for mod in (stitch_kernels, fused_embed):
        mod.library()
        for line in _build.BUILDS[mod.LIBRARY]["log"].splitlines():
            entry = re.search(r"entry function '\w*?\d+((?:un)?stitch_"
                              r"(?:decode_)?kernel\w*)'", line)
            if entry or "registers" in line:
                print(f"[{args.label}] ptxas: {line.strip()}")

    rng = np.random.default_rng(5)
    sizes = [(int(rng.integers(16, 449)), int(rng.integers(16, 225)))
             for _ in range(73)]
    patches = [Patch(0, 0, w, h) for w, h in sizes]
    plan = build_batch_plan(patches, stitch(patches, CANVAS, CANVAS),
                            CANVAS, CANVAS)
    crops = [rng.normal(size=(p.h, p.w, 3)).astype(np.float32)
             for p in patches]
    slots = torch.from_numpy(ops.pack_plan_host(crops, plan)).cuda()
    records = torch.from_numpy(plan.records).cuda()
    side = CANVAS // PATCH
    raw = torch.from_numpy(rng.normal(
        size=(plan.num_canvases, side, side, 5)).astype(np.float32)).cuda()
    cap = plan.slot_capacity
    live = plan.records[plan.records[..., 0] > 0]
    placed = int((live[:, 4] * live[:, 5]).sum()) * 3 * 4
    shape = {"b": plan.num_canvases, "k": plan.slots_per_canvas,
             "slots": [cap, plan.hmax, plan.wmax, 3]}

    one = torch.zeros(1, device="cuda")
    floor = timings(lambda: one.fill_(1.0))["ms_device"]
    cases = (
        ("stitch",
         lambda: ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                     impl="cuda"),
         lambda: ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                     impl="torch"),
         records.numel() * 4 + placed
         + plan.num_canvases * CANVAS * CANVAS * 3 * 4),
        ("unstitch_decode",
         lambda: ops.unstitch_decode(raw, records, PATCH, cap, impl="cuda"),
         lambda: ops.unstitch_decode(raw, records, PATCH, cap,
                                     impl="torch"),
         records.numel() * 4 + raw.numel() * 4 + cap * side * side * 5 * 4))
    for name, kern, plain, moved in cases:
        got, want = kern(), plain()
        row = {"label": args.label, "kernel": name, **shape,
               "max_abs_err": (got - want).abs().max().item(),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "bytes": moved, "launch_floor_ms": floor}
        row.update(timings(kern))
        row["share_of_bound"] = row["bound_ms"] / row["ms_device"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
