"""Logical-axis sharding (MaxText style), on ``torch.distributed.tensor``.

Port of ``repro/sharding.py``.  Models name the axes of their parameters
and activations with *logical* names ("batch", "embed", "mlp", ...); a
rule table resolves each name to mesh axes ("pod", "data", "model"), so
the same model runs on the single-pod (data, model) mesh, the multi-pod
(pod, data, model) mesh or a 1 x 1 mesh by swapping the table.  The
tables and the resolution are the JAX package's, verbatim.

A :class:`PartitionSpec` is the port's own: a tuple of ``None``, a mesh
axis name, or a tuple of names (one tensor dim over several mesh axes),
trailing ``None``s trimmed, so it equals JAX's ``P`` of the same entries
as a tuple.  :func:`placements` turns one into the DTensor ``Shard`` /
``Replicate`` of each mesh dim.  A dim over two mesh axes is split in
mesh order by DTensor and in the listed order by JAX (``("data", "pod")``
is data-major): the local shapes are equal, and they are what the port
counts; which rank holds which rows differs.

:func:`with_logical_constraint` reads the ambient mesh and rules
(``compat.shardingx.use_mesh``): inside a mesh it redistributes a DTensor
to the constraint's placements; outside one, or on a plain tensor, it
returns its input, as the JAX function is a no-op outside a mesh.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.compat import shardingx

# A logical axis resolves to a mesh axis name, a tuple of mesh axis names
# (product sharding), or None (replicated).
MeshAxes = Union[str, Tuple[str, ...], None]
Rules = Mapping[str, MeshAxes]

# Default rule table for the production meshes.  "batch" shards over the
# pure-DP axes (pod, data); weight matrices shard their wide dimension over
# "model".  Logical axes absent from the table are replicated.
DEFAULT_RULES: Rules = {
    "batch": ("data", "pod"),
    "decode_batch": ("data", "pod"),
    "seq": None,
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": None,
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "capacity": None,
    "layers": None,
    "img_h": None,
    "img_w": None,
    "channels": "model",
    "in_channels": None,
    "patch": None,
    "kv_seq": None,
    "canvas": ("data", "pod"),
    "stack": None,
    "expert_group": ("data", "pod"),
}

# FSDP rule overlay: additionally shard the parameter "embed" (contraction)
# dimension over the data axis so optimizer state is fully sharded (ZeRO-3
# style).  Used for >=100B-param configs (mistral-large-123b).
FSDP_OVERLAY: Rules = {
    "embed": "data",
}

# Sequence-parallel overlay for long-context decode cells: the KV cache
# shards its sequence dimension over "model".
SEQUENCE_OVERLAY: Rules = {
    "kv_seq": "model",
}

# Activation sequence-sharding (Megatron-SP-style) for big train cells:
# layer-boundary activations shard "seq" over "model"; GSPMD inserts the
# all-gather at the attention boundary and the reduce-scatter after —
# 16x less saved-activation memory for ~one extra collective pair/layer.
ACT_SEQ_OVERLAY: Rules = {
    "seq": "model",
}


def merge_rules(*tables: Optional[Rules]) -> Rules:
    out: dict = {}
    for t in tables:
        if t:
            out.update(t)
    return out


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis, or a tuple of mesh
    axes.  Equal as a tuple to JAX's ``PartitionSpec`` of the same
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(keep: Sequence[str]):
    return None if not keep else keep[0] if len(keep) == 1 else tuple(keep)


def _trimmed(parts: list) -> PartitionSpec:
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Rules,
    mesh=None,
) -> PartitionSpec:
    """Resolve a tuple of logical axis names to a PartitionSpec.

    Mesh axes that do not exist on the provided mesh are dropped (so the
    same rules work on a 1-device test mesh with no "model" axis).  A mesh
    axis may appear at most once in the spec; later duplicates are dropped.
    """
    available = set(mesh.axis_names) if mesh is not None else None
    used: set = set()
    parts = []
    for ax in logical_axes:
        resolved = rules.get(ax, None) if ax is not None else None
        if resolved is None:
            parts.append(None)
            continue
        axes = (resolved,) if isinstance(resolved, str) else tuple(resolved)
        keep = []
        for a in axes:
            if available is not None and a not in available:
                continue
            if a in used:
                continue
            used.add(a)
            keep.append(a)
        parts.append(_entry(keep))
    return _trimmed(parts)


def _divisible_parts(shape, logical_axes, rules: Rules, sizes: dict
                     ) -> list:
    used: set = set()
    parts = []
    for dim, ax in zip(shape, logical_axes):
        resolved = rules.get(ax) if ax is not None else None
        if resolved is None:
            parts.append(None)
            continue
        axes = (resolved,) if isinstance(resolved, str) else tuple(resolved)
        keep, prod = [], 1
        for a in axes:
            if a not in sizes or a in used:
                continue
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        parts.append(_entry(keep))
    return parts


def divisible_spec(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    rules: Rules,
    mesh,
) -> PartitionSpec:
    """Like ``logical_to_spec`` but drops mesh axes that do not divide the
    dim size evenly (required for jit input shardings).  For multi-axis
    rules like batch -> ("data", "pod") axes are kept greedily in order,
    skipping any axis whose inclusion would break divisibility.
    """
    sizes = shardingx.mesh_axis_sizes(mesh)
    return _trimmed(_divisible_parts(shape, logical_axes, rules, sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   rules: Rules) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, rules, mesh))


def divisible_sharding(mesh, shape, logical_axes, rules) -> NamedSharding:
    return NamedSharding(mesh, divisible_spec(shape, logical_axes, rules,
                                              mesh))


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placement of each mesh dim: ``Shard(d)`` where the
    spec puts that mesh axis on tensor dim ``d``, else ``Replicate()``.
    A mesh axis of size 1 is ``Replicate()`` whatever the spec says (its
    one shard is the whole tensor; DTensor would refuse to reshape
    through it)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = shardingx.mesh_axis_sizes(mesh)
    dim_of = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r} that the "
                                 f"mesh {mesh.axis_names} lacks")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in mesh.axis_names)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape one device holds of a tensor of ``shape`` laid out by
    ``spec`` (every sharded dim divides evenly, as ``divisible_spec``
    makes it)."""
    sizes = shardingx.mesh_axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {a!r} ({sizes[a]})")
            out[d] //= sizes[a]
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor: no tensor is
    one until ``torch.distributed.tensor`` has been imported (the dry run
    imports it).  Serving and training never import it, as its modules
    (sympy among them) would sit on the heap of every process and
    lengthen each full garbage collection of a host-bound loop; the
    DTensor paths here import what they use inside their functions."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def _laid_out(x, want) -> "DTensor":
    """DTensor ``x`` with the placements ``want`` (itself if it has
    them)."""
    want = tuple(want)
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]],
                            rules: Optional[Rules] = None):
    """Lay ``x`` out by its logical axes, if inside a mesh.

    Outside a mesh (``use_mesh``), and for a tensor that is not a DTensor,
    this returns ``x`` itself.  Inside one it redistributes the DTensor to
    the placements the rules give (``rules``, else the ambient ones),
    dropping mesh axes that do not divide the dim evenly: GSPMD technically
    supports uneven sharding via padding, but for e.g. 40 heads on a
    16-way axis it falls back to "involuntary full rematerialization"
    (replicate + reshard) which injects massive all-gathers — replicating
    outright is strictly better.
    """
    mesh = shardingx.get_abstract_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if rules is None:
        rules = shardingx.get_rules() or DEFAULT_RULES
    sizes = shardingx.mesh_axis_sizes(mesh)
    spec = _divisible_parts(x.shape, logical_axes, rules, sizes)
    return _laid_out(x, placements(spec, mesh))


def gather_dims(x, dims: Sequence[int]):
    """``x`` with the tensor dims ``dims`` replicated (an explicit
    all-gather) where a DTensor shards them; any other tensor as it is.
    For the points where DTensor cannot reshape through a sharded dim that
    GSPMD reshards implicitly."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    return _laid_out(x, (Replicate() if isinstance(pl, Shard)
                         and pl.dim in dims else pl for pl in x.placements))


def replicated(x):
    """A DTensor made whole on every device (pending sums reduced, shards
    gathered); any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return _laid_out(x, (Replicate(),) * x.device_mesh.ndim)


def per_shard(fn, x):
    """``fn(x)``; on a DTensor ``fn`` runs on each device's shard and the
    result keeps ``x``'s layout (a pending partial sum is reduced first).
    For a function that maps each shard on its own: an elementwise one
    DTensor has no strategy for (``log_sigmoid``'s backward), or any
    function of a ``replicated`` tensor (the ViT position resize, whose
    DTensor strategy builds tensors on the mesh's device, a card this
    host may not have)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return per_device(fn, pl, (pl,), x.device_mesh)(x)


def _reduced(x):
    """DTensor ``x`` with its pending partial sums reduced (replicated)."""
    from torch.distributed.tensor import Partial, Replicate
    return _laid_out(x, (Replicate() if isinstance(p, Partial) else p
                         for p in x.placements))


class _GatherGrad(torch.autograd.Function):
    """Identity whose backward replicates the gradient's ``dims``."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_dims(g, ctx.dims), None


def gather_grad_dims(x, dims: Sequence[int]):
    """``x`` itself, whose gradient has the tensor dims ``dims``
    replicated where a DTensor shards them (an explicit all-gather in the
    backward pass): for a reshape whose backward view would flatten a dim
    the next layer shards (DTensor refuses that view); any tensor that is
    not a DTensor, or needs no gradient, as it is."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _GatherGrad.apply(x, tuple(dims))


def per_device(fn, out_placements, in_placements, device_mesh):
    """``local_map(fn, ...)`` with its inputs redistributed to
    ``in_placements`` and their gradients' layouts stated: where an input
    is whole on a mesh dim that an output is split over (sharded, or a
    pending sum), each device's gradient of it is a partial sum (the
    weight of a batch-sharded product, a query read by every sequence
    shard); elsewhere the gradient is laid out as the input.
    ``out_placements``: one output's placements, or a sequence of them
    (one an output)."""
    from torch.distributed.tensor import Partial, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    multi = not isinstance(out_placements[0], Placement)
    outs = list(out_placements) if multi else [out_placements]
    grads = tuple(tuple(
        Partial() if isinstance(pl, Replicate) and any(
            not isinstance(o[d], Replicate) for o in outs) else pl
        for d, pl in enumerate(ins)) for ins in in_placements)
    return local_map(
        fn, out_placements=tuple(list(o) for o in outs) if multi
        else list(outs[0]),
        in_placements=tuple(tuple(p) for p in in_placements),
        in_grad_placements=grads, device_mesh=device_mesh,
        redistribute_inputs=True)


def _as_dtensor(x, like):
    """``x`` as a DTensor on ``like``'s mesh: itself, or a plain tensor
    taken as replicated (as ``implicit_replication`` takes it)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def _shard_start(x, dim: int) -> int:
    """The first index along ``dim`` this device's shard of DTensor ``x``
    holds (shards split in mesh order)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    span = x.to_local().shape[dim]
    start = 0
    for i in reversed(range(mesh.ndim)):
        if x.placements[i] == Shard(dim):
            start += mesh.get_local_rank(i) * span
            span *= mesh.shape[i]
    return start


def take_along(values, idx, dim: int):
    """``values.gather(dim, idx[..., None])[..., 0]`` for the last ``dim``:
    each row's entry at ``idx`` (``idx`` has ``values``' shape without
    ``dim``; indices in range).

    On a DTensor sharded along ``dim`` (a vocabulary-parallel logit or
    embedding table) each device gathers the indices its shard holds and
    the rest read 0: the result is a partial sum over those mesh dims,
    which the next reduction or constraint sums (GSPMD's masked gather).
    DTensor's own strategy for this builds masks that the ``meta`` device
    cannot hold."""
    def plain(v, i):
        return v.gather(dim, i.unsqueeze(dim)).squeeze(dim)
    if not is_dtensor(values):
        return plain(values, idx)
    from torch.distributed.tensor import Partial, Replicate, Shard
    values = _reduced(values)
    if Shard(dim) not in values.placements:
        return plain(values, _as_dtensor(idx, values))
    vp, ip, op = [], [], []
    for pl in values.placements:
        if pl == Shard(dim):
            vp.append(pl), ip.append(Replicate()), op.append(Partial())
        elif isinstance(pl, Shard) and pl.dim < dim:
            vp.append(pl), ip.append(pl), op.append(pl)
        else:
            vp.append(Replicate()), ip.append(Replicate())
            op.append(Replicate())
    idx = _as_dtensor(idx, values).redistribute(values.device_mesh, ip)
    values = values.redistribute(values.device_mesh, vp)
    start = _shard_start(values, dim)

    def fn(v, i):
        local = i - start
        inside = (local >= 0) & (local < v.shape[dim])
        got = plain(v, local.clamp(0, v.shape[dim] - 1))
        return torch.where(inside, got, torch.zeros_like(got))
    return per_device(fn, op, (vp, ip), values.device_mesh)(values, idx)


def take_rows(table, ids):
    """``table[ids]``: rows of a (V, d) table.  On a DTensor table sharded
    over its rows (the vocabulary-parallel embedding), each device looks
    up the ids its shard holds and the rest read 0: a partial sum over
    those mesh dims."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    if Shard(0) not in table.placements:
        return table[ids]
    table = _reduced(table)
    tp, ip, op = [], [], []
    ids = _as_dtensor(ids, table)
    for pl, ipl in zip(table.placements, ids.placements):
        if pl == Shard(0):
            tp.append(pl), ip.append(Replicate()), op.append(Partial())
        elif isinstance(ipl, Shard):
            tp.append(Replicate()), ip.append(ipl), op.append(ipl)
        else:
            tp.append(Replicate()), ip.append(Replicate())
            op.append(Replicate())
    table = table.redistribute(table.device_mesh, tp)
    ids = ids.redistribute(table.device_mesh, ip)
    start = _shard_start(table, 0)

    def fn(t, i):
        local = i - start
        inside = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return per_device(fn, op, (tp, ip), table.device_mesh)(table, ids)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Bundle of rule tables selected per arch/shape cell."""

    rules: Rules

    @staticmethod
    def make(fsdp: bool = False, sequence_parallel: bool = False,
             act_seq: bool = False,
             extra: Optional[Rules] = None) -> "ShardingConfig":
        rules = merge_rules(
            DEFAULT_RULES,
            FSDP_OVERLAY if fsdp else None,
            SEQUENCE_OVERLAY if sequence_parallel else None,
            ACT_SEQ_OVERLAY if act_seq else None,
            extra,
        )
        return ShardingConfig(rules=rules)
