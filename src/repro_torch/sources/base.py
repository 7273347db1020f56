"""Source protocol, stats record, and the source registry.

Port of ``repro/sources/base.py``.  A source yields
:class:`~repro_torch.data.video.Arrival` events in non-decreasing
``t_arrive`` order from ``events(engine)``; the engine passes itself in as
the backpressure handle (live sources read ``engine.backlog()`` between
frames, a trace ignores it).  ``stats()`` reports what the source did.
Sources are built by name through :func:`make_source`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Iterator, Protocol, Sequence, \
    runtime_checkable

from repro_torch.core.registry import lookup
from repro_torch.data.video import Arrival


@dataclasses.dataclass
class SourceStats:
    """What a source did.  ``frames_total`` counts frames the source
    considered (dropped ones included); ``patches_emitted`` equals the
    number of arrivals yielded.  A trace source has no frame loop, so its
    frame counters are zero."""

    kind: str = "source"
    arrivals: int = 0
    bytes_sent: float = 0.0
    transmission_seconds: float = 0.0
    frames_total: int = 0
    frames_dropped: int = 0
    frames_degraded: int = 0
    patches_emitted: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def add(self, other: "SourceStats") -> None:
        """Accumulate another source's counters (multi-camera merge)."""
        self.arrivals += other.arrivals
        self.bytes_sent += other.bytes_sent
        self.transmission_seconds += other.transmission_seconds
        self.frames_total += other.frames_total
        self.frames_dropped += other.frames_dropped
        self.frames_degraded += other.frames_degraded
        self.patches_emitted += other.patches_emitted


@runtime_checkable
class Source(Protocol):
    """What :meth:`~repro_torch.core.engine.ServingEngine.serve` needs."""

    def events(self, engine) -> Iterator[Arrival]:
        """Yield arrivals in non-decreasing ``t_arrive`` order."""

    def stats(self) -> SourceStats:
        """Accounting for the run so far."""


class MergedSource:
    """Several per-camera sources merged into one arrival stream, ordered
    by ``(t_arrive, camera_id, per-stream seq)`` so ties do not depend on
    the order the sources were listed in."""

    def __init__(self, sources: Sequence[Source]):
        if not sources:
            raise ValueError("MergedSource needs at least one source")
        self.sources = list(sources)

    def events(self, engine) -> Iterator[Arrival]:
        def keyed(stream):
            for seq, a in enumerate(stream):
                yield (a.t_arrive, a.patch.camera_id, seq), a

        streams = [keyed(s.events(engine)) for s in self.sources]
        for _key, a in heapq.merge(*streams, key=lambda ka: ka[0]):
            yield a

    def stats(self) -> SourceStats:
        total = SourceStats(kind=f"merged[{len(self.sources)}]")
        for s in self.sources:
            total.add(s.stats())
        return total


_SOURCES: Dict[str, Callable[..., Source]] = {}


def register_source(name: str, factory: Callable[..., Source]) -> None:
    """Register a source factory under ``name`` for :func:`make_source`."""
    _SOURCES[name] = factory


def make_source(name: str, **cfg) -> Source:
    """Source-name -> instance (``trace`` | ``synthetic`` | ``file``);
    ``cfg`` forwards to the registered factory."""
    factory = lookup("source", _SOURCES, name)
    return factory(**cfg)
