"""Failure handling for training: a deterministic failure schedule for
drills, and the elastic batch rule.

Port of the parts of ``repro/training/elastic.py`` that need no device
mesh.  A drill (``launch/train.py``) polls :class:`FailureInjector` each
step; on an event it drops its state and restores the latest committed
checkpoint, keeping the step counter and the data iterator where they are,
as the reference does.  ``shrink_mesh`` and ``ElasticState`` rebuild a
mesh without the failed data-parallel rows: they wait for ROADMAP item
14's ``torch.distributed`` DeviceMesh.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str              # "chip" | "host" | "straggler"
    data_row: int          # which data-parallel row is affected
    slow_factor: float = 1.0


class FailureInjector:
    """Deterministic failure schedule for integration tests and drills:
    each event fires once, at the first poll of its step."""

    def __init__(self, events: Sequence[FailureEvent]):
        self.events = sorted(events, key=lambda e: e.step)

    def poll(self, step: int) -> List[FailureEvent]:
        fired = [e for e in self.events if e.step == step]
        self.events = [e for e in self.events if e.step != step]
        return fired


def rescale_batch(global_batch: int, old_rows: int, new_rows: int) -> int:
    """Keep the per-replica batch constant across a shrink."""
    return global_batch // old_rows * new_rows
