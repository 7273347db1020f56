"""Run-to-run spread of a cell's end-to-end metrics, for its bounds.

    python3 tangram_bench/spread.py --workload <cell> --seeds a,b,c,d,e,f \
        [--sets 2] [--trace-seeds x,y,z]

Runs the benchmark's command once per seed in each set (the same seeds in
every set, each run a new process, one after another), then
``--trace-seeds`` with ``--trace 1``.  Prints every result line, then per
set and metric the median and the spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median.  A bound is about five times the widest spread of a
metric over the cells, and never under 1%.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMAND = [sys.executable, os.path.join("tangram_bench", "run.py")]


def run(workload, seed, seconds, trace):
    t0 = time.perf_counter()
    out = subprocess.run(
        COMMAND + ["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return {"seed": seed, "trace": trace, "rc": out.returncode,
            "wall_s": wall, "result": result,
            "stderr_tail": out.stderr[-1500:]}


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / abs(med)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace-seeds", default="")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        rows = []
        for seed in seeds:
            row = run(args.workload, seed, seconds, 0)
            row["set"] = k
            print(json.dumps(row), flush=True)
            rows.append(row)
        sets.append(rows)
    for seed in (int(s) for s in args.trace_seeds.split(",") if s):
        row = run(args.workload, seed, seconds, 1)
        row["set"] = "trace"
        print(json.dumps(row), flush=True)
    for k, rows in enumerate(sets):
        ok = [r["result"] for r in rows if r["result"]]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary = {}
        for name in names:
            values = [r["metrics"][name]["value"] for r in ok
                      if name in r["metrics"]]
            if len(values) >= 2:
                med, sp = spread(values)
                summary[name] = {"median": med, "spread": sp,
                                 "values": values}
        print(json.dumps({"set": k, "workload": args.workload,
                          "correct": [r["correct"] for r in ok],
                          "failed_runs": len(rows) - len(ok),
                          "spreads": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
