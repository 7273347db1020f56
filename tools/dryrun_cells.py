#!/usr/bin/env python3
"""Count dry-run cells of one or two checkouts, each cell in a fresh
process, and print the cells whose counts differ.

    python3 tools/dryrun_cells.py --root PARENT --root CHANGE [--depth 2]
                                  [--cell ARCH:SHAPE ...] [--repeats 3]
                                  [--jobs N]

For each checkout (``--root``, default: this repository) every cell of
``configs.all_cells()`` (or each ``--cell``) is planned and counted on
the 16 x 16 production mesh by that checkout's own
``launch/dryrun._job``, direct counts, every model cut to ``--depth``
layers, in a process of its own (``--jobs`` at once), ``--repeats``
times.  A cell's counts are the same in every process of a checkout
since the counter leaves DTensor's sharding propagation out
(``hlo_analysis._planning``: the meta tensors it allocates for each
candidate placement, tried in the order of a ``set``, so of the
process's string-hash seed, once moved a few serve and generation
cells' bytes by up to 4%); the repeats check that it stays so, and a
cell moved between two checkouts only where no count of one equals a
count of the other.  Prints one JSON line a checkout (each cell's
distinct counts of FLOPs, bytes, collective and argument bytes a
device), a line a cell whose counts vary within a checkout, and, given
two checkouts, a line a cell that moved, with the change in percent
(first count against first count).  Needs no card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = ("flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "arg_bytes")
_CELL = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
row, text, fail = dryrun._job({arch!r}, {shape!r}, "production", False,
                              "16x16", True, {depth!r})
print(json.dumps({{k: row[k] for k in {keys!r}}} if row else
                 {{"failure": repr(fail)}}))
"""


def _cells(root: str) -> list:
    code = (f"import sys; sys.path.insert(0, {str(pathlib.Path(root) / 'src')!r})\n"
            "from repro_torch import configs\n"
            "print('\\n'.join(f'{a}:{s.name}' for a, s in "
            "configs.all_cells()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return out.stdout.split()


def _count(root: str, cell: str, depth: int) -> dict:
    arch, shape = cell.split(":")
    code = _CELL.format(src=str(pathlib.Path(root) / "src"), arch=arch,
                        shape=shape, depth=depth, keys=KEYS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        return {"failure": out.stderr[-2000:]}
    return json.loads(lines[-1])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", action="append")
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--cell", action="append",
                   help="ARCH:SHAPE (default: every cell)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--jobs", type=int, default=len(os.sched_getaffinity(0)))
    args = p.parse_args()
    roots = args.root or [str(ROOT)]
    cells = args.cell or _cells(roots[0])
    counts = []
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        for root in roots:
            futures = {c: [pool.submit(_count, root, c, args.depth)
                           for _ in range(args.repeats)] for c in cells}
            runs = {c: [f.result() for f in fs] for c, fs in futures.items()}
            if any("failure" in r for rs in runs.values() for r in rs):
                print(json.dumps({"root": root, "failures": {
                    c: rs for c, rs in runs.items()
                    if any("failure" in r for r in rs)}}))
                return 1
            # each key's distinct counts, in the order first seen
            rows = {c: {k: list(dict.fromkeys(r[k] for r in rs))
                        for k in KEYS} for c, rs in runs.items()}
            counts.append(rows)
            print(json.dumps({"root": root, "depth": args.depth,
                              "repeats": args.repeats, "cells": rows}))
            for c, row in rows.items():
                varies = {k: v for k, v in row.items() if len(v) > 1}
                if varies:
                    print(json.dumps({"root": root, "cell": c,
                                      "varies": varies}))
    if len(counts) == 2:
        a, b = counts
        for c in cells:
            moved = {k: [a[c][k][0], b[c][k][0],
                         f"{(b[c][k][0] / a[c][k][0] - 1) * 100:+.2f}%"]
                     for k in KEYS if not set(a[c][k]) & set(b[c][k])}
            if moved:
                print(json.dumps({"cell": c, "moved": moved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
