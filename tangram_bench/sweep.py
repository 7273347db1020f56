"""The knee of a live cell: the highest common frame rate at which the
95th-percentile latency stays within the SLO and the backlog does not
grow.

    python3 tangram_bench/sweep.py --workload vit_s16-live \
        --fps 0.3,0.4,0.5,0.6 --seeds 7,8 [--seconds 51]

Each rate, with each seed, runs a fresh program on the cell's traffic
with ``fps`` replaced, for ``--seconds`` (by default the benchmark's
``run_seconds``).  One JSON line a rate and seed: the p95 latency, the
SLO misses, the p95 of the first and the second half of the window (a
growing backlog shows as a later half slower than the first), and how
late the engine took arrivals.  The cell's traffic file takes 4/5 of the
knee: the highest rate at which every seed's p95 is within the SLO and
no seed's second half is slower than its first by more than a tenth.
"""
import argparse
import gc
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from tangram_bench import harness, stats  # noqa: E402


def reading(data, fps: float, seed: int) -> dict:
    half = data.seconds / 2
    lat = stats.latencies(data)
    first = [x for (tg, _), x in zip(
        [p for p in data.patches if 0 <= p[0] < data.seconds], lat)
        if tg < half]
    second = [x for (tg, _), x in zip(
        [p for p in data.patches if 0 <= p[0] < data.seconds], lat)
        if tg >= half]

    def ms(values):
        if not values:
            return None
        v = stats.nearest_rank(values, 0.95)
        return None if math.isinf(v) else v * 1e3
    late = sorted(data.lateness) or [0.0]
    return {"fps": fps, "seed": seed, "patches": len(lat),
            "p95_ms": ms(lat), "p95_first_half_ms": ms(first),
            "p95_second_half_ms": ms(second),
            "slo_miss_pct": 100.0 * sum(x > data.slo for x in lat)
            / max(len(lat), 1),
            "late_p95_ms": stats.nearest_rank(late, 0.95) * 1e3,
            "late_max_ms": late[-1] * 1e3,
            "invocations": len(stats.window_invs(data))}


def knee_of(rows, slo_ms: float):
    """The highest rate whose every reading, and every lower rate's, has
    its p95 within the SLO and a second half no slower than a tenth over
    its first; None when the lowest rate fails."""
    knee = None
    for fps in sorted({r["fps"] for r in rows}):
        held = all(r["p95_ms"] is not None and r["p95_ms"] <= slo_ms
                   and r["p95_second_half_ms"] is not None
                   and r["p95_first_half_ms"] is not None
                   and r["p95_second_half_ms"]
                   <= 1.1 * r["p95_first_half_ms"]
                   for r in rows if r["fps"] == fps)
        if not held:
            break
        knee = fps
    return knee


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fps", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    cell, cfg, traffic, bench = harness.load_cell(args.workload)
    seconds = args.seconds or float(bench["run_seconds"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if not torch.cuda.is_available() or traffic["mode"] != "live":
        print("needs a CUDA device and a live cell", file=sys.stderr)
        return 2
    harness.steady_process()
    harness.set_cache_dirs()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    runs = [(float(f), s) for f in args.fps.split(",") for s in seeds]
    rows = []
    for fps, seed in runs:
        t = dict(traffic, fps=fps)
        recorder, weights, clips, program = harness.prepare(
            cfg, t, seed, device, seconds, 0)
        source, engine, _ = harness.serve_window(
            program, clips, cfg, t, seed, seconds, recorder)
        data = harness.RunData(
            seconds, float(t["slo_s"]), "live", cfg, t,
            list(recorder.order), harness.patch_outcomes(recorder, source),
            list(recorder.spans), None, source.lateness)
        row = reading(data, fps, seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del recorder, weights, clips, program, source, engine, data
        gc.collect()
        torch.cuda.empty_cache()
    knee = knee_of(rows, float(traffic["slo_s"]) * 1e3)
    print(json.dumps({"knee_fps": knee,
                      "cell_fps": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
