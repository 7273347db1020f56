"""The port's span log: what the executor, the engine and the clock did,
as intervals on one host clock, kept in memory.  Off by default.

``install(SpanLog())`` turns it on for the process and ``uninstall()``
off.  With no log installed, :func:`span` returns one shared null context
and :func:`event` returns at once: one global read and no allocation.
Spans sit at invocation granularity, never inside a per-patch loop.

A record is one tuple ``(name, t0, t1, parent, inv, value)``:

- ``t0``, ``t1``: the log's clock, by default ``time.perf_counter``
  seconds, the clock of ``WallClock`` and of the device executors;
- ``parent``: the index in ``records`` of the span that encloses it on
  the same thread (None at the top), so shard threads that record at
  once never cross parents;
- ``inv``: the invocation number the log gives out at staging
  (``span(..., inv=NEW)``); a span given none takes its parent's;
- ``value``: one number or short string.

A span takes its index when it opens and writes its record when it
closes, so ``records`` holds None at the index of a span still open.

Records and what reads them (``tangram_bench/metrics/``):

| record | where | value |
|---|---|---|
| ``stage``, children ``stage.plan`` / ``.pack`` / ``.h2d`` / ``.launch`` | ``DeviceExecutor._queue`` | canvases (``stage.h2d``: bytes shipped) |
| ``route``, children ``route.wait`` / ``.fused`` / ``.evidence`` (each patch's evidence: a view of its frame on the fused path, else a copy) | ``DeviceExecutor.submit`` / ``resolve`` | canvases |
| ``fire`` (zero length) | ``ServingEngine._dispatch`` | the invocation's reason |
| ``engine.late`` (due -> taken) | ``ServingEngine.offer`` / ``advance`` on a clock that is not virtual | ``"arrival"``, ``"timer"``, ``"completion"`` |
| ``engine.sleep`` | ``WallClock.advance_to`` | - |
| ``trunk`` (device-timed) | ``models/detector.forward_tokens`` | device ms, K4's tokens to the head |
| ``trunk.attn.window`` / ``.global`` (device-timed) | ``models/vit._block`` | device ms in the window / global blocks' attention, summed over the blocks |

Device-timed records (:func:`device_span`) time the device work queued
inside them: CUDA events on the current stream on a card, host stamps on
the CPU.  They belong to the invocation of the innermost open span
(``stage`` on the executor's path) and wait in the log until it is routed:
:func:`settle` then writes one zero-length record a name, stamped at the
routing, whose value is the device ms summed over its intervals.  Routing
has waited for the card by then, so reading the events adds no sync.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

#: the installed log; None when off (:func:`install`, :func:`uninstall`)
LOG: Optional["SpanLog"] = None

#: ``span(name, inv=NEW)`` numbers a new invocation
NEW = object()


class SpanLog:
    """Records in memory, in the order their spans opened."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.records: List[Optional[tuple]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._invs = itertools.count()
        #: inv -> [(name, start, end)] of device-timed spans not settled
        self._device: Dict[object, list] = {}

    def _stack(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record: Optional[tuple]) -> int:
        with self._lock:
            self.records.append(record)
            return len(self.records) - 1

    def event(self, name: str, t0: Optional[float] = None,
              t1: Optional[float] = None, inv=None, value=None) -> None:
        """A span that has already ended: ``t1`` now when unset, ``t0``
        equal to ``t1`` when unset."""
        if t1 is None:
            t1 = self.clock()
        stack = self._stack()
        outer = stack[-1] if stack else None
        if inv is None and outer is not None:
            inv = outer.inv
        self._append((name, t1 if t0 is None else t0, t1,
                      None if outer is None else outer.index, inv, value))

    def _timed(self, inv, name: str, start, end) -> None:
        with self._lock:
            self._device.setdefault(inv, []).append((name, start, end))

    def settle(self, inv) -> None:
        """Write invocation ``inv``'s device-timed records: one a name,
        its intervals' device ms summed."""
        with self._lock:
            timed = self._device.pop(inv, ())
        totals: Dict[str, float] = {}
        for name, start, end in timed:
            if isinstance(start, torch.cuda.Event):
                end.synchronize()           # complete already: routed
                ms = start.elapsed_time(end)
            else:
                ms = (end - start) * 1e3
            totals[name] = totals.get(name, 0.0) + ms
        for name, ms in totals.items():
            self.event(name, inv=inv, value=ms)


class _Span:
    __slots__ = ("log", "name", "inv", "value", "index", "parent", "t0")

    def __init__(self, log: SpanLog, name: str, inv, value):
        self.log, self.name, self.inv, self.value = log, name, inv, value

    def __enter__(self) -> "_Span":
        log = self.log
        stack = log._stack()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.index
        if self.inv is NEW:
            self.inv = next(log._invs)
        elif self.inv is None and outer is not None:
            self.inv = outer.inv
        self.index = log._append(None)
        stack.append(self)
        self.t0 = log.clock()
        return self

    def __exit__(self, *exc) -> bool:
        log = self.log
        t1 = log.clock()
        log._stack().pop()
        log.records[self.index] = (self.name, self.t0, t1, self.parent,
                                   self.inv, self.value)
        return False


class _NullSpan:
    """What :func:`span` returns with no log installed."""
    __slots__ = ()
    inv = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _DeviceSpan:
    __slots__ = ("log", "name", "inv", "device", "start")

    def __init__(self, log: SpanLog, name: str, inv, device: torch.device):
        self.log, self.name, self.inv, self.device = log, name, inv, device

    def _mark(self):
        if self.device.type != "cuda":
            return self.log.clock()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def __enter__(self) -> "_DeviceSpan":
        self.start = self._mark()
        return self

    def __exit__(self, *exc) -> bool:
        self.log._timed(self.inv, self.name, self.start, self._mark())
        return False


def install(log: SpanLog) -> None:
    global LOG
    LOG = log


def uninstall() -> None:
    global LOG
    LOG = None


def span(name: str, inv=None, value=None):
    """A context manager recording ``name`` from enter to exit; ``as``
    gives it, with its ``inv``."""
    log = LOG
    if log is None:
        return _NULL
    return _Span(log, name, inv, value)


def device_span(name: str, like: torch.Tensor):
    """A context manager timing the device work queued inside it on
    ``like``'s device, for the invocation of the innermost open span; the
    shared null context with no log installed or outside an invocation
    (nothing allocated, no event made)."""
    log = LOG
    if log is None:
        return _NULL
    stack = log._stack()
    inv = stack[-1].inv if stack else None
    if inv is None:
        return _NULL
    return _DeviceSpan(log, name, inv, like.device)


def settle(inv) -> None:
    """:meth:`SpanLog.settle` on the installed log, if any."""
    log = LOG
    if log is not None and inv is not None:
        log.settle(inv)


def event(name: str, t0: Optional[float] = None, t1: Optional[float] = None,
          inv=None, value=None) -> None:
    """:meth:`SpanLog.event` on the installed log, if any."""
    log = LOG
    if log is not None:
        log.event(name, t0, t1, inv, value)
