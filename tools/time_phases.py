#!/usr/bin/env python3
"""Time each phase of one checkout's ``chip_smoke.py`` on the card.

    python3 tools/time_phases.py [--root CHECKOUT] [--label NAME]
                                 [--log PATH]

Runs ``python3 -u chip_smoke.py`` from ``CHECKOUT`` (default: this
repository), stamps each line it prints with the seconds since the start
(host clock), writes the stamped lines to ``PATH`` (default:
``build/phases-NAME.log``), and prints one JSON line: the label,
the script's exit code, its wall seconds, and the seconds from each
``phase ...:`` header line to the next (the last phase ends at the
script's exit).  The phases' own readings (decode ms a step, a train
step, ...) are in the log.

Two checkouts are compared by running this script once for each in one
call on one card (parent, change): the script's ``chip_smoke.py`` is the
checkout's own, so a phase's time moves with that checkout's code and
with nothing else but the host.  Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# a phase's header ("phase 8b: ..."), not a closing time ("phase 11: 9.1s")
PHASE = re.compile(r"^phase ([0-9][0-9a-z/]*): (?![0-9.]+s$)")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--label", default="this")
    p.add_argument("--log")
    args = p.parse_args()
    log = pathlib.Path(args.log or ROOT / "build" /
                       f"phases-{args.label}.log")
    log.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    starts = []
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                                cwd=args.root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            t = time.perf_counter() - t0
            out.write(f"{t:9.2f} {line}")
            m = PHASE.match(line)
            if m:
                starts.append((m.group(1), t))
        rc = proc.wait()
    wall = time.perf_counter() - t0
    ends = [t for _, t in starts[1:]] + [wall]
    phases = {}
    for (name, t), end in zip(starts, ends):
        phases[name] = round(phases.get(name, 0.0) + end - t, 2)
    print(json.dumps({"label": args.label, "rc": rc, "wall_s": round(wall, 2),
                      "phases_s": phases, "log": str(log)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
