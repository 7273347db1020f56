"""The parallel fleet runtime: one thread per shard.

Port of ``repro/core/parallel.py``.  Each shard's
:class:`~repro_torch.core.engine.ServingEngine` runs on its own
:class:`ShardRunner` thread behind a bounded single-producer,
single-consumer inbox::

    router thread                      shard threads
    arrivals --+--> inbox[0] --> ShardRunner 0 --> engine 0 --+
               +--> inbox[1] --> ShardRunner 1 --> engine 1 --+--> merge

The router is the only producer and the runner the only consumer of each
inbox, so a full inbox holds the router back and nothing else needs a
lock.  A runner drains ``offer_batch`` runs as the sequential path does,
so each shard's transcript is unchanged, and the harvest is
:class:`~repro_torch.core.fleet.ShardedEngine`'s pinned ``(t_finish,
shard index, within-shard order)`` merge.  On one card each shard's device
executor runs on a CUDA stream of its own, so one shard's host staging
overlaps another's kernels (PyTorch releases the GIL while it waits on the
card).

Shard-local: the invoker pool, arrival slots, event heap and clock
(:meth:`~repro_torch.core.clock.WallClock.shard_view` or a barrier-clock
member).  Shared and safe under threads: the
:class:`~repro_torch.core.framestore.FrameStore`, the
:class:`~repro_torch.core.cost.CostMeter`, the
:class:`~repro_torch.core.latency.OnlineLatencyTable` and the kernels'
launch counts.  A shard thread's exception is raised again at
:meth:`ParallelShardedEngine.finish`, never swallowed.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence

from repro_torch.core.engine import PatchOutcome, ServingEngine
from repro_torch.core.fleet import FleetPlan, ShardedEngine
from repro_torch.data.video import Arrival

__all__ = ["ShardRunner", "ParallelShardedEngine"]

#: end-of-input sentinel (identity-compared; never a valid batch)
_STOP = object()


class ShardRunner(threading.Thread):
    """One shard's event loop on its own thread.

    The router thread feeds ``submit``; this thread drains the bounded
    inbox into ``engine.offer_batch`` and, at the stop sentinel, syncs
    the shard's barrier clock (when it has one) and finishes the
    engine — so trailing-canvas flushes overlap across shards too.

    ``submitted`` is written only by the router and ``consumed`` only
    by this thread (single-writer counters); their difference is the
    queued-arrival backlog without taking any lock.
    """

    def __init__(self, shard: int, engine: ServingEngine,
                 queue_depth: int = 64):
        super().__init__(name=f"shard-runner-{shard}", daemon=True)
        self.shard = shard
        self.engine = engine
        self.inbox: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.error: Optional[BaseException] = None
        self.submitted = 0
        self.consumed = 0
        self._t_end: Optional[float] = None

    def pending(self) -> int:
        """Arrivals submitted but not yet drained into the engine."""
        return self.submitted - self.consumed

    def submit(self, batch: Sequence[Arrival]) -> None:
        """Enqueue one same-shard arrival run (router thread only).

        Blocks when the inbox is full — the bounded queue *is* the
        backpressure on a shard that falls behind."""
        self.submitted += len(batch)
        self.inbox.put(batch)

    def stop(self, t_end: Optional[float] = None) -> None:
        """Signal end-of-input; the runner finishes its engine and
        exits (router thread only)."""
        self._t_end = t_end
        self.inbox.put(_STOP)

    def run(self) -> None:
        eng = self.engine
        sync = getattr(eng.clock, "sync", None)
        stopped = synced = False
        try:
            while True:
                item = self.inbox.get()
                if item is _STOP:
                    stopped = True
                    break
                eng.offer_batch(item)
                self.consumed += len(item)
            if sync is not None:
                synced = True
                sync()
            eng.finish(self._t_end)
        except BaseException as exc:        # delivered by finish()
            self.error = exc
            # drain the inbox first, so the router's bounded put() never
            # blocks on a dead shard and reaches every peer's stop; then
            # meet the peers at the barrier clock, once
            while not stopped:
                if self.inbox.get() is _STOP:
                    stopped = True
            if sync is not None and not synced:
                try:
                    sync()
                except BaseException:
                    pass


class ParallelShardedEngine(ShardedEngine):
    """:class:`ShardedEngine` with each shard on a :class:`ShardRunner`.

    Same construction, routing, merge rule, and observability surface
    as the sequential engine; only the *execution* of the shard loops
    moves onto threads.  Runners start lazily on the first offer and
    are joined (and their errors re-raised) by :meth:`finish`.
    """

    def __init__(self, shards: Sequence[ServingEngine],
                 shard_of_camera: Callable[[int], int],
                 plan: Optional[FleetPlan] = None,
                 queue_depth: int = 64):
        super().__init__(shards, shard_of_camera, plan=plan)
        if queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = queue_depth
        self._runners: Optional[List[ShardRunner]] = None

    # ----------------------------------------------------------- feeding ----

    def _start(self) -> List[ShardRunner]:
        if self._runners is None:
            self._runners = [ShardRunner(s, eng, self.queue_depth)
                             for s, eng in enumerate(self.shards)]
            for r in self._runners:
                r.start()
        return self._runners

    def offer(self, arrival: Arrival):
        self._outcomes = None
        self._start()[self.shard_of(arrival.patch)].submit([arrival])

    def run(self, arrivals: Sequence[Arrival]) -> List[PatchOutcome]:
        """Route a merged fleet trace to the shard threads and drain.

        Same consecutive-run batching as the sequential engine — the
        router touches each same-shard *run*, not each event."""
        self._outcomes = None
        runners = self._start()
        shard_of_camera = self.shard_of_camera
        run_buf: List[Arrival] = []
        current = -1
        for arr in arrivals:
            s = shard_of_camera(arr.patch.camera_id)
            if s != current:
                if run_buf:
                    runners[current].submit(run_buf)
                    run_buf = []
                current = s
            run_buf.append(arr)
        if run_buf:
            runners[current].submit(run_buf)
        self.finish()
        return self.outcomes

    # ------------------------------------------------------------ finish ----

    def finish(self, t_end: Optional[float] = None):
        runners, self._runners = self._runners, None
        if runners is None:
            # nothing ever routed through the threads — sequential
            # finish (aligns barrier clocks, finishes every shard)
            super().finish(t_end)
            return
        for r in runners:
            r.stop(t_end)
        for r in runners:
            r.join()
        for r in runners:
            if r.error is not None:
                raise r.error
        for s, eng in enumerate(self.shards):
            for inv in eng.invocations:
                if inv.shard is None:
                    inv.shard = s
        self._finished = True
        self._outcomes = None

    # ------------------------------------------------------- backpressure ----

    def backlog(self) -> int:
        """Global backlog: shard-engine backlogs plus arrivals still
        queued in runner inboxes (advisory read across threads)."""
        n = super().backlog()
        if self._runners is not None:
            n += sum(r.pending() for r in self._runners)
        return n
