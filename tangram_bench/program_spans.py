"""The port's own spans (``repro_torch.core.spans``) in a ``--trace 1``
run, in engine seconds, for the readers of program spans.

The harness loads a cell's per-layer readers before it builds the program,
and only with ``--trace 1``.  The readers of the program's spans import
this module, and importing it installs one span log in the port; so the
untraced runs, which give the end-to-end metrics, keep the log off.  A
program without a span log gives the readers nothing to read.

The log's stamps are ``time.perf_counter`` seconds, the clock of the
harness's ``Recorder`` and of the port's ``WallClock``.  :func:`records`
takes the harness's epoch from the window's ``submit`` spans: the
program's ``stage`` spans open and close inside them, one each, in order.
The log records from set-up on; a window's records are those at engine
times from 0 (the window opens) on.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

from tangram_bench.trace import idle_gaps

try:
    from repro_torch.core import spans as _spans
except ImportError:             # a program without a span log
    _spans = None

if _spans is not None and _spans.LOG is None:
    _spans.install(_spans.SpanLog())

#: what marks lateness or an instant, not what the host was doing
NOT_ACTIVITY = ("engine.late", "fire")


def records(run) -> Optional[list]:
    """The program's records, ``(name, t0, t1, parent, inv, value)``, in
    engine seconds (None at the index of a span still open); None when
    there are none or the epoch cannot be found.  Kept on
    ``run.program_spans``."""
    got = getattr(run, "program_spans", None)
    if got:
        return got
    log = _spans.LOG if _spans is not None else None
    if log is None or not log.records:
        return None
    epoch = epoch_of(log.records, run.spans)
    if epoch is None:
        return None
    run.program_spans = [
        None if r is None else (r[0], r[1] - epoch, r[2] - epoch, *r[3:])
        for r in list(log.records)]
    return run.program_spans


def epoch_of(recs: list, harness_spans: list) -> Optional[float]:
    """The host time of engine second 0: the window's ``submit`` spans
    (engine seconds) paired in order with the last as many ``stage``
    records (host seconds).  Each stage opens after its submit did, so the
    least gap is the epoch to within the wrapper's own microseconds; None
    when the two do not pair (a stage outside its submit)."""
    submits = [(a, b) for kind, a, b in harness_spans if kind == "submit"]
    stages = [r for r in recs if r is not None and r[0] == "stage"]
    if not submits or len(stages) < len(submits):
        return None
    pairs = list(zip(stages[len(stages) - len(submits):], submits))
    epoch = min(st[1] - a for st, (a, _) in pairs)
    if any(st[2] - epoch > b + 1e-6 for st, (_, b) in pairs):
        return None
    return epoch


def window_canvases(recs: list, seconds: float) -> Dict[int, int]:
    """inv -> canvases of the invocations whose ``stage`` starts inside
    the window."""
    return {r[4]: r[5] for r in recs
            if r is not None and r[0] == "stage" and 0.0 <= r[1] < seconds}


def ms_per_canvas(run, names) -> Optional[float]:
    """Host ms in the records named ``names`` of the window's invocations,
    per canvas they carried."""
    recs = records(run)
    if not recs:
        return None
    invs = window_canvases(recs, run.seconds)
    canvases = sum(invs.values())
    if not canvases:
        return None
    busy = sum(r[2] - r[1] for r in recs
               if r is not None and r[0] in names and r[4] in invs)
    return busy * 1e3 / canvases


def in_window(recs: list, name: str, seconds: float) -> List[tuple]:
    """The records named ``name`` that start inside the window."""
    return [r for r in recs
            if r is not None and r[0] == name and 0.0 <= r[1] < seconds]


# ---------------------------------------- idle gaps against the spans ----

def innermost(recs: list) -> List[tuple]:
    """(start, end, name) stretches, in order, each under one innermost
    activity span (the latest opened of those covering it): the program's
    timeline.  Lateness and instants are left out."""
    edges = []
    for i, r in enumerate(recs):
        if r is not None and r[0] not in NOT_ACTIVITY and r[2] > r[1]:
            edges.append((r[1], 1, i))
            edges.append((r[2], 0, i))
    edges.sort()
    out, active, prev = [], set(), None
    for t, opens, i in edges:
        if active and prev is not None and t > prev:
            out.append((prev, t, recs[max(active)][0]))
        if opens:
            active.add(i)
        else:
            active.discard(i)
        prev = t
    return out


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """Seconds of the window's device idle time under each innermost
    program span (``None``: under no span)."""
    recs = records(run)
    if not recs or run.trace is None:
        return None
    gaps = idle_gaps([(a, b) for _, a, b in run.trace.events], 0.0,
                     run.seconds)
    segs = innermost(recs)
    out: Dict[Optional[str], float] = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
            k += 1
        out[None] = out.get(None, 0.0) + (b - a) - covered
    return out


def gap_labels(run) -> Optional[list]:
    """The trace's ``breakdown`` idle gaps, longest first, each label
    followed by ``/`` and the innermost program span at the gap's
    midpoint (as ``host routing/route.evidence at 44.246 s``)."""
    recs = records(run)
    if not recs or run.trace is None:
        return None
    named = run.trace.breakdown(run)["idle_gaps"]
    gaps = idle_gaps([(a, b) for _, a, b in run.trace.events], 0.0,
                     run.seconds)
    gaps.sort(key=lambda g: g[0] - g[1])
    segs = innermost(recs)
    out = []
    for (label, length), (a, b) in zip(named, gaps):
        mid = (a + b) / 2
        name = next((n for s0, s1, n in segs if s0 <= mid <= s1), None)
        if name is not None:
            head, _, tail = label.partition(" at ")
            label = f"{head}/{name} at {tail}"
        out.append([label, length])
    return out


def log_size() -> Optional[dict]:
    """The installed log's records and the bytes they hold (each object
    counted once)."""
    log = _spans.LOG if _spans is not None else None
    if log is None:
        return None
    seen, total = set(), sys.getsizeof(log.records)
    for r in log.records:
        for obj in (r, *(r or ())):
            if id(obj) not in seen:
                seen.add(id(obj))
                total += sys.getsizeof(obj)
    return {"records": len(log.records), "bytes": total}
