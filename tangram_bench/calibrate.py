"""Readings for the output check's limits, many seeds in one process.

    python3 tangram_bench/calibrate.py --workload <cell> \
        --seeds 11,12,... [--seconds 6]

For each seed: the cell's weights, clips and warmed program, a window of
``--seconds`` at the cell's own load, then the check's numbers for the
program and for the control (the reference with fp8 products in the
program's place) on the same sampled invocations.  One JSON line a reading; the limits in ``configs/<name>.json``
lie between the largest program reading and the smallest control one.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from tangram_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    cell, cfg, traffic, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        (prog, ctl), data, peak, _ = harness.run_checked(
            cfg, traffic, seed, device, args.seconds, control=True)
        for name, values, readings in (
                ("program", prog, data.readings),
                ("control_fp8", ctl, data.control_readings)):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": name, "checks": values,
                              "readings": readings,
                              "invocations": len(data.invs),
                              "patches": len(data.patches),
                              "peak_bytes": peak,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        del prog, ctl, data
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
