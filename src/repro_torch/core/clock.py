"""Pluggable engine clocks: virtual time for simulation/replay, wall time
for live serving.

Port of ``repro/core/clock.py``.  :class:`VirtualClock` jumps between
events, so a trace replays as fast as the host processes events;
:class:`WallClock` sleeps to each event instant (``speed`` compresses the
replay).  Both are monotone: ``advance_to`` never moves engine time
backwards.  For the fleet's shard threads, :meth:`WallClock.shard_view`
gives each thread a private monotone floor on one shared timeline, and
:class:`BarrierVirtualClock` gives each shard a private virtual clock that
meets the others at a barrier at end of input.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Protocol, runtime_checkable

from repro_torch.core import spans
from repro_torch.core.registry import lookup


@runtime_checkable
class Clock(Protocol):
    """What :class:`~repro_torch.core.engine.ServingEngine` needs."""

    #: True when ``advance_to`` jumps instantly (simulation semantics).
    virtual: bool

    def now(self) -> float:
        """Current engine time in seconds."""

    def advance_to(self, t: float) -> None:
        """Move engine time forward to ``t`` (no-op when already past)."""


class VirtualClock:
    """Discrete-event time: ``advance_to`` jumps, nothing sleeps."""

    virtual = True

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = t


class WallClock:
    """Engine time anchored to real time; ``advance_to`` sleeps.

    ``speed`` is engine-seconds per wall-second (1.0 = real time).
    ``now()`` is clamped monotone.
    """

    virtual = False

    def __init__(self, speed: float = 1.0,
                 time_fn: Callable[[], float] = time.perf_counter,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if speed <= 0:
            raise ValueError(f"speed must be positive, got {speed}")
        self.speed = speed
        self._time_fn = time_fn
        self._sleep_fn = sleep_fn
        self._epoch = time_fn()
        self._floor = 0.0

    def now(self) -> float:
        t = (self._time_fn() - self._epoch) * self.speed
        if t > self._floor:
            self._floor = t
        return self._floor

    def advance_to(self, t: float) -> None:
        dt = (t - self.now()) / self.speed
        if dt > 0:
            with spans.span("engine.sleep"):
                self._sleep_fn(dt)
        # an event scheduled at t has happened by the time advance_to
        # returns, even if sleep undershot by a scheduler tick
        if t > self._floor:
            self._floor = t

    def shard_view(self) -> "WallClock":
        """A view of this clock for one shard thread: the same epoch,
        speed and time/sleep functions (one timeline, so engine times
        stamped through different views compare directly), but a private
        monotone floor, which ``now()`` writes on every read and which one
        floor shared across threads would make a data race."""
        view = WallClock.__new__(WallClock)
        view.speed = self.speed
        view._time_fn = self._time_fn
        view._sleep_fn = self._sleep_fn
        view._epoch = self._epoch
        view._floor = 0.0
        return view


class _BarrierMember:
    """One shard's handle on a :class:`BarrierVirtualClock`: a private
    virtual clock between sync points (a shard's transcript is that of a
    plain :class:`VirtualClock`); ``sync()`` blocks until every member
    arrives, then all stand at the fleet-wide maximum time."""

    virtual = True

    def __init__(self, parent: "BarrierVirtualClock", t0: float):
        self.parent = parent
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = t

    def sync(self) -> None:
        self.parent._sync()


class BarrierVirtualClock:
    """Virtual time for N shard threads with a barrier at end of input.

    Each shard advances its member (:meth:`clock`) privately.  Threaded
    runners call ``member.sync()`` at end of input, which blocks until all
    ``parties`` members arrive and lifts every member to the largest
    member time; the sequential path calls :meth:`align`, the same lift
    without blocking.  Both leave every member at one engine time, so
    threaded and sequential transcripts compare.  The wait is bounded by
    ``timeout_s``: a shard thread that never arrives raises
    ``RuntimeError`` instead of hanging the fleet.
    """

    virtual = True

    def __init__(self, parties: int, t0: float = 0.0,
                 timeout_s: float = 60.0):
        if parties < 1:
            raise ValueError(f"parties must be >= 1, got {parties}")
        self.parties = parties
        self.timeout_s = timeout_s
        self.members: List[_BarrierMember] = [
            _BarrierMember(self, t0) for _ in range(parties)]
        self._cv = threading.Condition()
        self._arrived = 0
        self._generation = 0

    def clock(self, shard: int) -> _BarrierMember:
        return self.members[shard]

    def align(self) -> None:
        """Lift every member to the largest member time (non-blocking)."""
        t = max(m._t for m in self.members)
        for m in self.members:
            if t > m._t:
                m._t = t

    def _sync(self) -> None:
        with self._cv:
            gen = self._generation
            self._arrived += 1
            if self._arrived == self.parties:
                self.align()
                self._arrived = 0
                self._generation += 1
                self._cv.notify_all()
                return
            if not self._cv.wait_for(lambda: self._generation != gen,
                                     timeout=self.timeout_s):
                raise RuntimeError(
                    f"barrier clock timed out after {self.timeout_s}s "
                    f"({self._arrived}/{self.parties} shards arrived: a "
                    f"shard thread deadlocked or died)")


_CLOCKS = {
    "virtual": VirtualClock,
    "wall": WallClock,
}


def make_clock(name: str, **cfg) -> Clock:
    """Clock-name -> instance (``virtual`` | ``wall``).  ``speed`` is
    accepted, and ignored, for the virtual clock so one config dict can
    drive either name."""
    cls = lookup("clock", _CLOCKS, name)
    if cls is VirtualClock:
        cfg = {k: v for k, v in cfg.items() if k != "speed"}
    return cls(**cfg)
