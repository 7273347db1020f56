#!/usr/bin/env python3
"""One benchmark run with the port's span log, and what the log saw.

    python3 tools/span_runs.py --spans 0|1 --workload CELL --seed N \
        --seconds S --trace 0|1

Runs ``tangram_bench``'s ``harness.main`` in this process with the span
log (``repro_torch.core.spans``) installed from the start (``--spans 1``,
through ``tangram_bench/program_spans.py``) or not (``--spans 0``; with
``--trace 1`` the cell's readers of program spans install it all the
same).  Prints the harness's JSON line, then one of its own: the log's
records and bytes, the window's records by name, its invocations and
canvases, host ms a canvas in each staging and routing span, device ms
a canvas in the trunk's device-timed records, the engine's lateness by
kind and the fire reasons, and with ``--trace 1`` the window's device
idle seconds under each innermost span and the
``breakdown``'s idle gaps named by span.  Where the executor stages
through a pool (``DeviceExecutor._stage``), the line adds ``staging``:
the staging buffers allocated or grown (``pinned_allocs``) when the
window opened and when its last invocation was staged, the window's
bytes shipped (``h2d_bytes``) against the padded slots' bytes, and the
patches whose evidence the window's routing handed out as views of
their frames and as copies (``evidence_views``, ``evidence_copies``;
null where the executor counts neither).

Runs at ``--spans 0`` and ``--spans 1`` with ``--trace 0``, the same seeds,
in turns on one card, give what the log costs the end-to-end metrics.
Needs a CUDA card, as the harness does; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

T0 = time.perf_counter()        # set-up is timed from here, as run.py does
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SPANS = ("stage", "stage.plan", "stage.pack", "stage.h2d", "stage.launch",
         "route", "route.wait", "route.fused", "route.evidence")
DEVICE = ("trunk", "trunk.attn.window", "trunk.attn.global")


def report(data) -> dict:
    from tangram_bench import device_spans
    from tangram_bench import program_spans as ps
    from tangram_bench import stats
    recs = ps.records(data)
    if not recs:
        return {"log": ps.log_size(), "records": None}
    window = [r for r in recs
              if r is not None and 0.0 <= r[1] < data.seconds]
    lags = collections.defaultdict(list)
    for r in ps.in_window(recs, "engine.late", data.seconds):
        lags[r[5]].append(r[2] - r[1])
    invs = ps.window_canvases(recs, data.seconds)
    out = {"log": ps.log_size(), "window_records": len(window),
           "invocations": len(invs), "canvases": sum(invs.values()),
           "by_name": collections.Counter(r[0] for r in window),
           "ms_per_canvas": {n: ps.ms_per_canvas(data, (n,)) for n in SPANS},
           "device_ms_per_canvas": {n: device_spans.ms_per_canvas(data, n)
                                    for n in DEVICE},
           "late_ms": {k: {"n": len(v),
                           "p50": stats.nearest_rank(v, 0.5) * 1e3,
                           "p95": stats.nearest_rank(v, 0.95) * 1e3,
                           "max": max(v) * 1e3} for k, v in lags.items()},
           "fire": collections.Counter(
               r[5] for r in ps.in_window(recs, "fire", data.seconds))}
    if data.trace is not None:
        idle = ps.idle_by_span(data)
        out["idle_s_by_span"] = {str(k): v for k, v in
                                 sorted(idle.items(), key=lambda kv: -kv[1])}
        out["idle_gaps"] = ps.gap_labels(data)
    return out


def watch_staging(harness, stages: list, workers: list) -> None:
    """Wrap ``harness.build_program`` so that each staging of the worker
    appends (in the window, ``pinned_allocs``, bytes shipped, padded slot
    bytes, ``evidence_views``, ``evidence_copies``) to ``stages``; the
    worker goes into ``workers``."""
    build_program = harness.build_program

    def build(cfg, weights, device, recorder):
        program = build_program(cfg, weights, device, recorder)
        worker = program.worker
        stage = getattr(worker, "_stage", None)
        if stage is None:
            return program
        workers.append(worker)

        def staged(inv, plan, rt):
            before = worker.h2d_bytes
            out = stage(inv, plan, rt)
            slot_bytes = (4 * out[0].shape[-1] * plan.slot_capacity
                          * plan.hmax * plan.wmax)
            stages.append((recorder.recording, worker.pinned_allocs,
                           worker.h2d_bytes - before, slot_bytes,
                           *evidence_counts(worker)))
            return out

        worker._stage = staged
        return program

    harness.build_program = build


def evidence_counts(worker) -> tuple:
    """The worker's ``evidence_views`` and ``evidence_copies`` so far (None
    for a counter it does not keep)."""
    return (getattr(worker, "evidence_views", None),
            getattr(worker, "evidence_copies", None))


def staging_report(stages: list, worker=None) -> dict:
    """``pinned_allocs`` after warm-up, at the first staging from the
    window's opening on and at the last, and the index among those
    stagings of the last that changed it; bytes shipped against the padded
    slots' bytes over those stagings (the drain included); and the
    patches routed from the first of them on whose evidence was a view of
    its frame or a copy, read from ``worker`` at the end."""
    warm = [s for s in stages if not s[0]]
    served = [s for s in stages if s[0]]
    out = {"stagings": len(stages),
           "pinned_allocs_after_warm_up": warm[-1][1] if warm else 0}
    if served:
        shipped = sum(s[2] for s in served)
        slots = sum(s[3] for s in served)
        grew = [i for i in range(1, len(served))
                if served[i][1] != served[i - 1][1]]
        out.update(served_stagings=len(served),
                   pinned_allocs_first=served[0][1],
                   pinned_allocs_last=served[-1][1],
                   last_growth_at=grew[-1] if grew else 0,
                   h2d_bytes=shipped, slot_bytes=slots,
                   shipped_share=shipped / slots)
        for name, first, last in zip(
                ("evidence_views", "evidence_copies"), served[0][4:],
                evidence_counts(worker)):
            out[name] = (None if first is None or last is None
                         else last - first)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spans", type=int, choices=(0, 1), required=True)
    args, rest = p.parse_known_args()
    if args.spans:
        from tangram_bench import program_spans  # noqa: F401 (installs)
    from tangram_bench import harness
    kept = {}
    run_checked = harness.run_checked

    def keep(*a, **kw):
        out = run_checked(*a, **kw)
        kept["data"] = out[1]
        return out

    harness.run_checked = keep
    stages, workers = [], []
    watch_staging(harness, stages, workers)
    rc = harness.main(rest, t0=T0)
    line = {"spans": args.spans}
    if "tangram_bench.program_spans" in sys.modules and "data" in kept:
        line.update(report(kept["data"]))
    if stages:
        line["staging"] = staging_report(stages, workers[-1])
    print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
