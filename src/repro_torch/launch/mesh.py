"""Mesh construction for every launch surface.

Port of ``repro/launch/mesh.py``.  Functions, not module-level constants:
importing this module touches no device and starts no process group.

The production, test and unit meshes are abstract (ranks, no card): the
dry run plans and counts on them (``compat.shardingx.device_mesh``).  The
serve meshes are laid over local ``torch.device``s, the CUDA devices by
default: one process drives them all, splitting each canvas batch over
the ``data`` axis (``core/engine.shard_canvases``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.compat import shardingx


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; multi_pod stacks 2 pods (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shardingx.make_mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False):
    """Small stand-in meshes (8 devices) for the tests."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shardingx.make_mesh(shape, axes)


def make_unit_mesh():
    """1x1 (data, model) mesh: the same rule tables resolve, every axis
    collapses to size 1."""
    return shardingx.make_mesh((1, 1), ("data", "model"))


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """``devices`` as a list of ``torch.device``s, or every CUDA device
    (``torch.cuda.device_count()``) when None; raises without CUDA, so a
    CPU mesh is always the caller's explicit choice."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the serve mesh; pass "
                           "devices=[torch.device('cpu')] (or several) to "
                           "serve on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_serve_mesh(n_devices: Optional[int] = None, devices=None):
    """Data-parallel serving mesh over the local devices.

    The canvas batch shards its leading axis over "data"; "model" is kept
    (size 1) so the standard rule tables resolve unchanged.  On one device
    this degenerates to the unit mesh and sharding is a no-op — the serve
    driver runs identically either way.  A device may appear more than
    once (``data=2`` over one card runs the split on it).
    """
    devs = local_devices(devices)
    n = n_devices if n_devices is not None else len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"n_devices {n} of {len(devs)} devices")
    return shardingx.make_mesh((n, 1), ("data", "model"), devices=devs[:n])


def make_worker_meshes(n_workers: int, devices=None):
    """Split the device set into ``n_workers`` independent serve meshes.

    Each worker mesh is a contiguous (data, model) slice the shape of
    :func:`make_serve_mesh`, so per-worker executors shard their canvas
    batches data-parallel *within* their slice while the worker pool
    routes concurrent invocations *across* slices.  With fewer devices
    than workers the devices are reused round-robin (worker i pins device
    ``i % n_devices`` — on a 1-device host every worker degenerates to
    the unit mesh and the pool still exercises the full routing path).
    Leftover devices (``n_devices % n_workers``) are left unused so every
    worker has identical capacity and the latency profile of one worker
    holds for all.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    devs = local_devices(devices)
    if len(devs) >= n_workers:
        per = len(devs) // n_workers
        slices = [devs[i * per:(i + 1) * per] for i in range(n_workers)]
    else:
        slices = [[devs[i % len(devs)]] for i in range(n_workers)]
    return [shardingx.make_mesh((len(sl), 1), ("data", "model"), devices=sl)
            for sl in slices]


def mesh_chips(mesh) -> int:
    return mesh.devices.size
