#!/usr/bin/env python3
"""Whether the benchmark's output check can fail on a ViTDet cell: one
window of the cell served by the port, then its sampled invocations held
against the reference by ``harness.check``, once with the program's
outputs and once with each control's in their place.

    python3 tools/vitdet_controls.py --workload vitdet_l-replay \
        --seeds 2718281828,1618033988 [--seconds 15] [--samples 3]

The controls, each computed from the same canvases and weights:

- ``fp8``: the reference with every product's operands rounded to fp8
  (``harness.control_outputs``, the precision below the configuration's);
- ``no_rel_pos``: the trunk with bf16 products (the yardstick's) but no
  relative-position terms;
- ``all_global``: the same with every block attending over the whole
  grid, its window tables interpolated to the grid (as ViTDet's
  ``get_rel_pos`` interpolates a table of another size).

One JSON line a seed: each side's ``head_err`` and ``k4_token_err`` (the
compared statistics), the limits, and whether each control reads over
the ``head_err`` limit, as it must.  ``--samples`` sets the number of
sampled invocations (the largest is checked too).  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from tangram_bench import families, harness, reference  # noqa: E402


def structural(rel_pos: bool, all_global: bool):
    """A ``harness.control_outputs`` of a trunk that departs from the
    published one, in bf16 products."""
    def control_outputs(canvases, records, weights, cfg, n_slots, origins):
        side = cfg["canvas"] // cfg["patch"]
        tokens = reference.embed(canvases, weights, cfg["patch"],
                                 reference.mm_bf16)
        raw = families.load(cfg).trunk_raw(
            tokens, weights, side, cfg["norm_eps"], reference.mm_bf16,
            windows=[0] * cfg["n_layers"] if all_global else None,
            rel_pos=rel_pos)
        grids = reference.decode_gather(raw, records, cfg["patch"], n_slots)
        routed = reference.route(records, origins, grids.cpu().numpy())
        return tokens, raw, grids, routed
    return control_outputs


CONTROLS = {"fp8": harness.control_outputs,
            "no_rel_pos": structural(False, False),
            "all_global": structural(True, True)}


def controls(cfg, traffic, seed: int, device, seconds: float,
             samples: int) -> dict:
    """The program's and each control's compared numbers on one window."""
    recorder, weights, clips, program = harness.prepare(
        cfg, traffic, seed, device, seconds, samples)
    source, engine, book = harness.serve_window(
        program, clips, cfg, traffic, seed, seconds, recorder)
    del engine, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    keys = ("head_err", "k4_token_err")
    out = {"seed": seed, "checked": len(recorder.checked_samples()),
           "limits": {k: cfg["limits"][k] for k in keys}}
    got = harness.check(recorder, source, book, cfg, weights, device)
    out["program"] = {k: got[k] for k in keys}
    own = harness.control_outputs
    try:
        for name, fn in CONTROLS.items():
            harness.control_outputs = fn
            got = harness.check(recorder, source, book, cfg, weights, device,
                                control=True)
            out[name] = {k: got[k] for k in keys}
            out[name]["fails"] = got["head_err"] > cfg["limits"]["head_err"]
    finally:
        harness.control_outputs = own
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--samples", type=int, default=3)
    args = p.parse_args()
    _, cfg, traffic, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    harness.steady_process()
    harness.set_cache_dirs()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        print(json.dumps(controls(cfg, traffic, seed, device, args.seconds,
                                  args.samples)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
