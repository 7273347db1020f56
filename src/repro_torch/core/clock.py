"""Pluggable engine clocks: virtual time for simulation/replay, wall time
for live serving.

Port of ``VirtualClock``, ``WallClock`` and ``make_clock`` from
``repro/core/clock.py``.  :class:`VirtualClock` jumps between events, so a
trace replays as fast as the host processes events; :class:`WallClock`
sleeps to each event instant (``speed`` compresses the replay).  Both are
monotone: ``advance_to`` never moves engine time backwards.
"""
from __future__ import annotations

import time
from typing import Callable, Protocol, runtime_checkable

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
            self._sleep_fn(dt)
        # an event scheduled at t has happened by the time advance_to
        # returns, even if sleep undershot by a scheduler tick
        if t > self._floor:
            self._floor = t


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
