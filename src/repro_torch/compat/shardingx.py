"""The one mesh type of the port, and the ambient mesh and rules.

Port of ``repro/compat/shardingx.py``.  The JAX module papers over the
drift of ``jax.make_mesh`` / ``AxisType`` / ``set_mesh`` across jax
versions behind ``HAS_*`` flags; torch has no such drift in what this
module uses, so those flags are gone and there is one code path.

A :class:`Mesh` is a numpy array of devices with axis names, as JAX's
``Mesh`` is:

* an *abstract* mesh holds ranks ``0 .. size-1`` (ints).  It plans and
  counts (``launch/dryrun.py``): :func:`device_mesh` gives it a
  ``torch.distributed`` ``DeviceMesh`` over those ranks of a process
  group of the test backend ``"fake"`` with 512 ranks, started on first
  use and never before, whose collectives move nothing.  Tensors laid
  out on it live on the ``meta`` device.
* a *device* mesh holds ``torch.device``s (``launch/mesh.make_serve_mesh``):
  one controller process drives every device, and a data-parallel batch
  is split into one chunk a device (``core/engine.shard_canvases``).  It
  needs no process group.

:func:`use_mesh` makes a mesh, and a rule table, ambient for the thread:
``sharding.with_logical_constraint`` reads them.  Importing this module
starts no process group and sets no environment variable.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

#: ranks of the fake process group every abstract mesh is laid over (the
#: multi-pod production mesh, 2 x 16 x 16, is the largest)
FAKE_WORLD = 512


class Mesh:
    """Devices (or ranks) on named axes.

    ``devices`` is a numpy array whose shape is the axis sizes;
    ``axis_names`` names its axes; ``shape`` maps each name to its size in
    axis order (JAX's ``mesh.shape``); ``size`` is the device count.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if devices.ndim != len(names):
            raise ValueError(f"devices of shape {devices.shape} for axes "
                             f"{names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        self.devices = devices
        self.axis_names = names

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def abstract(self) -> bool:
        """True when the mesh holds ranks, not devices."""
        return all(isinstance(d, (int, np.integer))
                   for d in self.devices.flat)

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else "devices"
        return f"Mesh({self.shape}, {kind})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices=None) -> Mesh:
    """The one mesh factory: (shape, axes) -> :class:`Mesh`.  With
    ``devices`` (a sequence of ``torch.device``s, exactly as many as the
    shape holds) the mesh is laid over them in order; without, it is
    abstract, over ranks ``0 .. prod(shape)-1``."""
    shape = tuple(int(s) for s in axis_shapes)
    n = math.prod(shape)
    if devices is None:
        arr = np.arange(n, dtype=object).reshape(shape)
    else:
        devices = list(devices)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a mesh of "
                             f"{shape}")
        arr = np.empty(n, dtype=object)
        arr[:] = devices
        arr = arr.reshape(shape)
    return Mesh(arr, axis_names)


def mesh_from_devices(device_array, axis_names: Sequence[str]) -> Mesh:
    """Mesh from an explicit device (or rank) array (the elastic re-mesh
    path, where the surviving rows of a failed mesh are kept in place)."""
    return Mesh(device_array, axis_names)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size}, for this module's meshes and for any object with
    ``axis_names`` and ``devices.shape`` (the tests' stand-in meshes)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


# ------------------------------------------------------------- ambient ----

_LOCAL = threading.local()


def _stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Mapping] = None):
    """Make ``mesh`` (and the logical-axis ``rules``) ambient for this
    thread inside the block, as ``jax.sharding.set_mesh`` makes a mesh
    ambient.  Blocks nest; the innermost wins."""
    stack = _stack()
    stack.append((mesh, dict(rules) if rules is not None else None))
    try:
        yield mesh
    finally:
        stack.pop()


def get_abstract_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside :func:`use_mesh`."""
    stack = _stack()
    return stack[-1][0] if stack else None


def get_rules() -> Optional[dict]:
    """The ambient rule table, or None outside :func:`use_mesh` (or when
    the block gave none)."""
    stack = _stack()
    return stack[-1][1] if stack else None


# ------------------------------------------------------ process group ----

_DEVICE_MESHES: Dict[tuple, object] = {}


def _fake_world():
    """Start the fake process group of :data:`FAKE_WORLD` ranks once per
    process (this process is rank 0).  Collectives on it move nothing."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < FAKE_WORLD:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already running; the abstract meshes need {FAKE_WORLD}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD)


def device_mesh(mesh: Mesh):
    """The ``torch.distributed`` ``DeviceMesh`` of an abstract mesh: its
    axes over ranks ``0 .. size-1`` of the fake process group (started
    here on first use), device type ``cuda``, one per (shape, names),
    cached.  No card is needed: the tensors laid out on it are ``meta``
    tensors, and the fake group's collectives move nothing."""
    if not mesh.abstract:
        raise ValueError("device_mesh lays out abstract meshes only; a "
                         "device mesh needs no process group")
    key = (mesh.axis_sizes, mesh.axis_names)
    dm = _DEVICE_MESHES.get(key)
    if dm is None:
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        _fake_world()
        ranks = torch.arange(mesh.size).view(mesh.axis_sizes)
        # laid out as a mesh of cards, so DTensor plans the collectives a
        # CUDA mesh runs (on a "cpu" mesh it trades all-to-all for
        # all-gather); its tensors stay on the meta device
        dm = DeviceMesh("cuda", ranks, mesh_dim_names=mesh.axis_names)
        _DEVICE_MESHES[key] = dm
    return dm
