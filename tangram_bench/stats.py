"""Window arithmetic shared by the metric readers: each statistic is one
figure over the whole window, never a median of chunks."""
from __future__ import annotations

import math
from typing import List, Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile by nearest rank (``ceil(q * n)``-th smallest)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def latencies(run) -> List[float]:
    """Capture-to-routed seconds of every patch generated in the window;
    a patch not routed by the drain's end (window + one SLO) is a miss
    and counts as infinite."""
    limit = run.seconds + run.slo
    return [math.inf if tr is None or tr > limit else tr - tg
            for tg, tr in run.patches if 0.0 <= tg < run.seconds]


def window_invs(run) -> list:
    """Invocations whose submit started inside the window."""
    return [r for r in run.invs if r.t_submit0 < run.seconds]


def staging_ms_per_canvas(run) -> float | None:
    """Host seconds inside the worker's ``submit`` (crop gather, slot
    packing, host-to-device copy, launches) per canvas, over the window."""
    invs = window_invs(run)
    canvases = sum(r.n_canvases for r in invs)
    if not canvases:
        return None
    return sum(r.t_submit1 - r.t_submit0 for r in invs) * 1e3 / canvases
