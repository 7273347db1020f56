"""Failure handling for training: a deterministic failure schedule for
drills, the elastic re-mesh and the elastic batch rule.

Port of ``repro/training/elastic.py``.  A drill (``launch/train.py``)
polls :class:`FailureInjector` each step; on an event it drops its state
and restores the latest committed checkpoint, keeping the step counter and
the data iterator where they are, as the reference does.
:func:`shrink_mesh` rebuilds a mesh (``compat.shardingx.Mesh``) without
the failed data-parallel rows and :class:`ElasticState` follows it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.compat import shardingx


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


def shrink_mesh(mesh: shardingx.Mesh, failed_data_rows: Sequence[int]
                ) -> shardingx.Mesh:
    """Rebuild the mesh without the failed data-parallel rows.

    Device array layout is (data, model) or (pod, data, model); we drop
    rows along the *data* axis so every surviving replica keeps a full
    model shard group.  Raises if no rows survive.
    """
    names = tuple(mesh.axis_names)
    data_idx = names.index("data")
    devs = np.asarray(mesh.devices)
    failed = set(failed_data_rows)
    keep = [i for i in range(devs.shape[data_idx]) if i not in failed]
    if not keep:
        raise RuntimeError("all data-parallel rows failed")
    return shardingx.mesh_from_devices(np.take(devs, keep, axis=data_idx),
                                       names)


def rescale_batch(global_batch: int, old_rows: int, new_rows: int) -> int:
    """Keep the per-replica batch constant across a shrink."""
    return global_batch // old_rows * new_rows


@dataclasses.dataclass
class ElasticState:
    mesh: shardingx.Mesh
    global_batch: int
    generation: int = 0

    def on_failure(self, failed_rows: Sequence[int]) -> "ElasticState":
        names = tuple(self.mesh.axis_names)
        old_rows = np.asarray(self.mesh.devices).shape[names.index("data")]
        mesh = shrink_mesh(self.mesh, failed_rows)
        new_rows = np.asarray(mesh.devices).shape[names.index("data")]
        return ElasticState(
            mesh=mesh,
            global_batch=rescale_batch(self.global_batch, old_rows, new_rows),
            generation=self.generation + 1)
