"""Trace replay as a source.

Port of ``repro/sources/trace.py``: per-camera patch streams shaped
through one FIFO uplink each and merged, or an already-shaped arrival list
replayed verbatim.  A trace ignores backpressure: the events already
happened.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from repro_torch.core.partitioning import Patch
from repro_torch.data.video import Arrival, merge_arrivals, shape_arrivals
from repro_torch.sources.base import SourceStats


class TraceSource:
    """Replay ``streams`` (+ ``bandwidth_bps``) or pre-shaped
    ``arrivals`` (exactly one of the two)."""

    def __init__(self, streams: Optional[Sequence[Sequence[Patch]]] = None,
                 bandwidth_bps: Optional[float] = None,
                 arrivals: Optional[Sequence[Arrival]] = None):
        if (streams is None) == (arrivals is None):
            raise ValueError("pass exactly one of streams= or arrivals=")
        if streams is not None:
            if bandwidth_bps is None:
                raise ValueError("streams= requires bandwidth_bps=")
            per_cam = [shape_arrivals(s, bandwidth_bps) for s in streams]
            self.arrivals: List[Arrival] = merge_arrivals(per_cam)
        else:
            self.arrivals = list(arrivals)

    def events(self, engine) -> Iterator[Arrival]:
        return iter(self.arrivals)

    def stats(self) -> SourceStats:
        return SourceStats(
            kind="trace",
            arrivals=len(self.arrivals),
            bytes_sent=sum(a.n_bytes for a in self.arrivals),
            transmission_seconds=sum(a.t_arrive - a.patch.t_gen
                                     for a in self.arrivals),
            patches_emitted=len(self.arrivals))
