"""The device trace of a ``--trace 1`` run: ``torch.profiler`` on the
card's activity alone (kernels, copies, memsets) from before the window
opens until the drain ends.

A marker kernel (``torch.cuda._sleep``) launched on an idle card the
moment the window opens ties the trace's clock to the host's, so device
intervals read in engine seconds beside the benchmark's host spans.  The
trace is written to ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return gaps


class TraceData:
    """Device events in engine seconds: ``events`` (name, start, end)."""

    def __init__(self, events: List[Tuple[str, float, float]],
                 seconds: float):
        self.events = events
        self.seconds = seconds
        self.window_s = float(seconds)
        self.busy_s = union_length([(a, b) for _, a, b in events], 0.0,
                                   seconds)

    def kernels(self, pattern: str) -> List[Tuple[str, float, float]]:
        """Every traced event whose name holds ``pattern`` (window and
        drain)."""
        return [e for e in self.events if pattern in e[0]]

    def breakdown(self, run) -> dict:
        """The window's ten device operations that took most time, and
        its ten longest idle gaps named by what the host was doing."""
        by_name: dict = {}
        for name, a, b in self.events:
            a, b = max(a, 0.0), min(b, self.seconds)
            if b > a:
                short = (name.replace("(anonymous namespace)::", "")
                         .removeprefix("void ")[:80])
                by_name[short] = by_name.get(short, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = idle_gaps([(a, b) for _, a, b in self.events], 0.0,
                         self.seconds)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            mid = (a + b) / 2
            what = next((kind for kind, s0, s1 in run.spans
                         if s0 <= mid <= s1), None)
            label = {"submit": "staging", "resolve": "routing"}.get(
                what, "engine")
            named.append([f"host {label} at {a:.3f} s", b - a])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": named}


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.mark_host: Optional[float] = None
        self.seconds = 0.0
        self.data: Optional[TraceData] = None

    def start(self) -> None:
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()

    def mark(self, recorder) -> None:
        torch.cuda.synchronize()
        a = recorder.now()
        torch.cuda._sleep(100)
        b = recorder.now()
        self.mark_host = (a + b) / 2
        self.seconds = recorder.seconds

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        events = [e for e in raw.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = [e for e in events if MARKER in e.get("name", "")]
        if not marks:
            return
        offset = float(marks[0]["ts"]) * 1e-6 - self.mark_host
        out = []
        for e in events:
            if e is marks[0]:
                continue
            a = float(e["ts"]) * 1e-6 - offset
            out.append((e.get("name", ""), a, a + float(e["dur"]) * 1e-6))
        self.data = TraceData(out, self.seconds)
