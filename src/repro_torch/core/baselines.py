"""Baseline serving policies from Section V-A, as engine batchers.

Port of ``repro/core/baselines.py`` (plain Python).

* Full Frame   — whole 4K frame per request, triggered in sequence.
* Masked Frame — non-RoIs masked, still full resolution per request [35].
* ELF          — every patch its own request [12].
* Clipper      — AIMD dynamic batch size over padded fixed-size tiles [23].
* MArk         — max-batch + timeout over padded fixed-size tiles [24].

Every policy is a batcher over the same
:class:`~repro_torch.core.engine.ServingEngine` event loop Tangram runs
on (arrivals, timers, completions — no hand-rolled loops), dispatching
to the same ``SimExecutor`` / ``Platform``, so cost/SLO comparisons
isolate the batching policy.
Clipper and MArk cannot batch variable-size inputs, so patches are padded
to a fixed tile (``tile_side``); that padding waste vs Tangram's stitching
is exactly the paper's point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.engine import Results, ServingEngine, SimExecutor
from repro_torch.core.invoker import Invocation
from repro_torch.core.partitioning import Patch
from repro_torch.data import video
from repro_torch.data.video import Arrival, merge_arrivals, shape_arrivals
from repro_torch.serverless.platform import Platform


@dataclasses.dataclass(frozen=True)
class FrameMeta:
    """Per-frame record for the frame-level baselines."""
    width: int
    height: int
    fg_area: int
    t_gen: float
    slo: float
    camera_id: int = 0

    @property
    def deadline(self) -> float:
        return self.t_gen + self.slo


def _frame_arrivals(frames: Sequence[FrameMeta], bandwidth_bps: float,
                    masked: bool) -> List[Arrival]:
    byte_rate = bandwidth_bps / 8.0
    link_free = 0.0
    out = []
    for f in frames:
        b = (video.masked_frame_bytes(f.width, f.height, f.fg_area)
             if masked else video.frame_bytes(f.width, f.height))
        start = max(f.t_gen, link_free)
        t_arr = start + b / byte_rate
        link_free = t_arr
        proxy = Patch(0, 0, f.width, f.height, t_gen=f.t_gen, slo=f.slo,
                      camera_id=f.camera_id)
        out.append(Arrival(t_arr, proxy, b))
    return out


# --------------------------------------------------------------- batchers ----

class PassthroughBatcher:
    """Every arrival fires immediately as its own invocation.

    ``cost_for(patch)`` gives the invocation's canvas-equivalent billing
    size (1.0 for frame-level baselines, fractional for ELF).
    """

    def __init__(self, cost_for: Callable[[Patch], float] = lambda p: 1.0):
        self.cost_for = cost_for

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        return [Invocation(t_now, [], [patch], 0.0, "arrival",
                           cost_canvases=self.cost_for(patch))]

    def poll(self, t_now: float) -> Optional[Invocation]:
        return None

    def flush(self, t_now: float) -> Optional[Invocation]:
        return None

    def next_timer(self) -> float:
        return math.inf


class ClipperBatcher:
    """AIMD dynamic batch size (Additive-Increase Multiplicative-Decrease).

    Requests are patches padded to a fixed tile; a batch fires when the
    queue reaches the current target; the target grows +1 when the batch
    met its SLO budget and halves on violation.  The engine delivers the
    ``on_result`` feedback at *completion-delivery* time — the batcher
    learns a batch's fate when its result lands, as the real Clipper
    does, so arrivals in the dispatch->finish window still see the old
    target.  A drain timer (slo/2) bounds tail waiting, as in Clipper's
    adaptive batching.
    """

    def __init__(self, tile_equiv: float, drain: float):
        self.tile_equiv = tile_equiv
        self.drain = drain
        self.target = 1.0
        self.items: List[Tuple[float, Patch]] = []

    def _fire(self, t_now: float) -> Invocation:
        batch = self.items[: max(1, int(self.target))]
        del self.items[: len(batch)]
        return Invocation(t_now, [], [p for _, p in batch], 0.0, "clipper",
                          cost_canvases=len(batch) * self.tile_equiv)

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        self.items.append((t_now, patch))
        if len(self.items) >= int(self.target):
            return [self._fire(t_now)]
        return []

    def on_result(self, inv: Invocation, t_finish: float):
        ok = all(t_finish <= p.deadline for p in inv.patches)
        self.target = self.target + 1.0 if ok else max(1.0, self.target / 2.0)

    def next_timer(self) -> float:
        return self.items[0][0] + self.drain if self.items else math.inf

    def poll(self, t_now: float) -> Optional[Invocation]:
        if self.items and t_now >= self.items[0][0] + self.drain:
            return self._fire(self.items[0][0] + self.drain)
        return None

    def flush(self, t_now: float) -> Optional[Invocation]:
        if self.items:
            return self._fire(self.items[0][0] + self.drain)
        return None


class MArkBatcher:
    """Max-batch + timeout batching over padded tiles."""

    def __init__(self, tile_equiv: float, max_batch: int, timeout: float):
        self.tile_equiv = tile_equiv
        self.max_batch = max_batch
        self.timeout = timeout
        self.items: List[Tuple[float, Patch]] = []

    def _fire(self, t_now: float) -> Invocation:
        batch = list(self.items)
        self.items.clear()
        return Invocation(t_now, [], [p for _, p in batch], 0.0, "mark",
                          cost_canvases=len(batch) * self.tile_equiv)

    def on_patch(self, t_now: float, patch: Patch) -> List[Invocation]:
        fired = []
        # inclusive timeout: an arrival landing exactly on the boundary
        # still triggers the pending batch first (the engine only fires
        # timers scheduled strictly before an arrival)
        if self.items and t_now - self.items[0][0] >= self.timeout:
            fired.append(self._fire(self.items[0][0] + self.timeout))
        self.items.append((t_now, patch))
        if len(self.items) >= self.max_batch:
            fired.append(self._fire(t_now))
        return fired

    def next_timer(self) -> float:
        return self.items[0][0] + self.timeout if self.items else math.inf

    def poll(self, t_now: float) -> Optional[Invocation]:
        if self.items and t_now >= self.items[0][0] + self.timeout:
            return self._fire(self.items[0][0] + self.timeout)
        return None

    def flush(self, t_now: float) -> Optional[Invocation]:
        if self.items:
            return self._fire(self.items[0][0] + self.timeout)
        return None


# ---------------------------------------------------------------- runners ----

def _run(name: str, batcher, arrivals, per_cam, platform: Platform
         ) -> Results:
    engine = ServingEngine(batcher, SimExecutor(platform))
    outcomes = engine.run(arrivals)
    bytes_sent = sum(a.n_bytes for cam in per_cam for a in cam)
    trans = sum(a.t_arrive - a.patch.t_gen for cam in per_cam for a in cam)
    return Results(
        name=name, outcomes=outcomes, canvas_efficiencies=[],
        batch_sizes=[len(i.patches) for i in engine.invocations],
        patches_per_batch=[len(i.patches) for i in engine.invocations],
        bytes_sent=bytes_sent, total_cost=platform.total_cost,
        invocations=len(platform.records),
        exec_seconds=platform.meter.busy_seconds,
        transmission_seconds=trans,
        mean_consolidation=platform.mean_consolidation)


def run_frame_baseline(frame_streams: Sequence[Sequence[FrameMeta]],
                       bandwidth_bps: float, platform: Platform,
                       masked: bool, name: Optional[str] = None) -> Results:
    """Full Frame / Masked Frame: one request per frame, in sequence."""
    per_cam = [_frame_arrivals(s, bandwidth_bps, masked)
               for s in frame_streams]
    return _run(name or ("masked_frame" if masked else "full_frame"),
                PassthroughBatcher(), merge_arrivals(per_cam), per_cam,
                platform)


def run_elf(streams: Sequence[Sequence[Patch]], bandwidth_bps: float,
            platform: Platform, canvas_area: int) -> Results:
    """Every patch is its own request (fractional canvas-equivalents)."""
    per_cam = [shape_arrivals(s, bandwidth_bps) for s in streams]
    batcher = PassthroughBatcher(
        lambda p: max(p.area / canvas_area, 0.05))
    return _run("elf", batcher, merge_arrivals(per_cam), per_cam, platform)


def run_clipper(streams: Sequence[Sequence[Patch]], bandwidth_bps: float,
                platform: Platform, canvas_area: int, tile_side: int = 512,
                slo: float = 1.0) -> Results:
    per_cam = [shape_arrivals(s, bandwidth_bps) for s in streams]
    batcher = ClipperBatcher(tile_side * tile_side / canvas_area,
                             drain=slo / 2.0)
    return _run("clipper", batcher, merge_arrivals(per_cam), per_cam,
                platform)


def run_mark(streams: Sequence[Sequence[Patch]], bandwidth_bps: float,
             platform: Platform, canvas_area: int, tile_side: int = 512,
             max_batch: int = 8, timeout: float = 0.25) -> Results:
    per_cam = [shape_arrivals(s, bandwidth_bps) for s in streams]
    batcher = MArkBatcher(tile_side * tile_side / canvas_area,
                          max_batch=max_batch, timeout=timeout)
    return _run("mark", batcher, merge_arrivals(per_cam), per_cam, platform)
