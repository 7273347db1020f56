"""In-process accelerator stand-ins for overlap and pool tests.

Port of ``repro/core/devicestub.py``.  A real accelerator accepts a
dispatch, queues it behind earlier work and computes without host CPU; the
host waits only when it reads a result.

* :class:`StubAccelerator` reproduces that with one worker thread (a
  serial device queue) and a fixed service time a call.  Its
  ``serve_fn(params, canvases)`` returns :class:`DeviceFuture` outputs in
  the detector's shapes (objectness ``(B, s, s)``, boxes ``(B, s, s, 4)``)
  at once.  A future answers ``query()``, the probe a ``torch.cuda.Event``
  answers and :class:`~repro_torch.core.engine.AsyncDeviceExecutor`
  reads, so the executor drives the stub as it drives the card (off a
  card its ``done`` is the outputs' own probe), and ``cpu()`` joins the
  call, as a device tensor's host copy does.
* :class:`VirtualAccelerator` is a submit/resolve executor whose finish
  times live on the engine clock: one serial queue, ``t_finish =
  max(t_submit, queue_free) + service``, no threads and no sleeps.
"""
from __future__ import annotations

import concurrent.futures
import time
from typing import Callable, Tuple, Union

import numpy as np
import torch


class DeviceFuture:
    """One output of an in-flight stub call."""

    def __init__(self, fut: concurrent.futures.Future, idx: int):
        self._fut = fut
        self._idx = idx

    def query(self) -> bool:
        """True once the call has finished (``torch.cuda.Event.query``)."""
        return self._fut.done()

    def result(self) -> np.ndarray:
        return self._fut.result()[self._idx]

    def cpu(self) -> torch.Tensor:
        """The output on the host; waits for the call."""
        return torch.from_numpy(self.result())


class StubAccelerator:
    """Serial device queue with a fixed service time a call."""

    def __init__(self, service_s: float, grid: int = 2):
        self.service_s = service_s
        self.grid = grid
        self.n_calls = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def serve_fn(self, params, canvases) -> Tuple[DeviceFuture, DeviceFuture]:
        b = int(canvases.shape[0])
        self.n_calls += 1
        fut = self._pool.submit(self._run, b)
        return DeviceFuture(fut, 0), DeviceFuture(fut, 1)

    def _run(self, b: int):
        # the canvases are ready when serve_fn is called: the executor
        # stitches them on the host before it dispatches the detector
        time.sleep(self.service_s)
        s = self.grid
        return (np.zeros((b, s, s), np.float32),
                np.zeros((b, s, s, 4), np.float32))

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "StubAccelerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class VirtualAccelerator:
    """Engine-time device stand-in: a submit/resolve executor whose finish
    times live on the engine clock, not the wall clock.

    ``service`` is seconds a call: a float, or ``service(batch_size) ->
    seconds``.  One serial queue: an invocation starts when it is
    submitted and the queue is free and finishes ``service`` later, so
    placement and drift tests reproduce exactly under the virtual clock.
    Handles carry their finish time at submit, so the engine schedules
    delivery on its event heap, as for ``SimExecutor``.
    """

    def __init__(self, service: Union[float, Callable[[int], float]]):
        self.service = service
        self.queue_free = 0.0
        self.n_calls = 0
        self.per_batch: list = []      # (t_submit, batch, t_finish) log

    def _service_s(self, batch: int) -> float:
        if callable(self.service):
            return float(self.service(batch))
        return float(self.service)

    def submit(self, inv) -> "ExecHandle":
        from repro_torch.core.engine import Completion, ExecHandle

        batch = len(inv.canvases) or len(inv.patches)
        start = max(inv.t_submit, self.queue_free)
        t_finish = start + self._service_s(batch)
        self.queue_free = t_finish
        self.n_calls += 1
        self.per_batch.append((inv.t_submit, batch, t_finish))
        return ExecHandle(inv, t_finish=t_finish,
                          completion=Completion(inv, t_finish))

    def resolve(self, handle) -> "Completion":
        return handle.completion
