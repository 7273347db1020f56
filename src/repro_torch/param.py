"""Parameter spec trees: one source of truth for shapes and init rules.

Port of ``repro/param.py``.  A model's ``param_specs(cfg)`` is a nested
dict of :class:`ParamSpec`; :func:`init_params` materialises it with the
JAX package's rules and :func:`count_params` counts it.  The logical
sharding axes of the JAX specs are dropped: the port runs on one card
(sharding is ROADMAP item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # normal | zeros | ones | embed | pos
    scale: float = 1.0          # stddev multiplier
    fan_in_axes: Tuple[int, ...] = ()  # dims of the fan-in (default: all
    #                                    but the last)


def spec(shape: Sequence[int], *, dtype: torch.dtype = torch.float32,
         init: str = "normal", scale: float = 1.0,
         fan_in_axes: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, init, scale, tuple(fan_in_axes))


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of nested dicts and lists (of specs,
    arrays or tensors), keeping the structure (dicts in insertion order)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def from_numpy(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array (e.g. a JAX parameter through ``np.asarray``; bf16
    arrays are ml_dtypes', whose bits are reinterpreted) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def convert_like(tree, specs, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
    """A tree of numpy arrays (e.g. the JAX package's parameters through
    ``np.asarray``, its stacked layers already cut into per-layer
    subtrees) as tensors on ``device``, each leaf cast to the dtype of its
    spec in ``specs`` (a :func:`spec` tree of the same structure): the
    parameter dtype, or int8 values and float32 scales for an int8
    weight; bf16 arrays keep their bits.  ``dtype``, when given, is every
    leaf's dtype instead (an optimizer's float32 moments, which have the
    parameters' tree)."""
    device = resolve_device(device)

    def walk(node, s):
        if isinstance(s, ParamSpec):
            t = from_numpy(node, dtype or s.dtype, device)
            if tuple(t.shape) != s.shape:
                raise ValueError(f"leaf of shape {tuple(t.shape)} where the "
                                 f"spec has {s.shape}")
            return t
        if isinstance(s, list):
            if len(node) != len(s):
                raise ValueError(f"{len(node)} subtrees where the specs "
                                 f"have {len(s)}")
            return [walk(n, x) for n, x in zip(node, s)]
        if set(node) != set(s):
            raise KeyError(f"keys {sorted(node)} where the specs have "
                           f"{sorted(s)}")
        return {k: walk(node[k], s[k]) for k in s}

    return walk(tree, specs)


def leaves(tree):
    """The leaves of nested dicts and lists, in the tree's order."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from leaves(v)
    else:
        yield tree


def sorted_leaves(tree) -> list:
    """The leaves of nested dicts and lists in ``jax.tree_util``'s order:
    dict keys sorted, lists in order (the order of a checkpoint's leaves,
    so either package restores the other's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def replace_leaves(tree, new_leaves: Iterable):
    """``tree`` with its leaves replaced, in :func:`sorted_leaves` order,
    by ``new_leaves``."""
    it = iter(new_leaves)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in leaves(specs))


def _std(s: ParamSpec) -> float:
    if s.init == "normal":
        axes = s.fan_in_axes or tuple(range(len(s.shape) - 1))
        fan_in = math.prod(s.shape[a] for a in axes) or 1
        return s.scale / math.sqrt(fan_in)
    return 0.02 * s.scale                      # "embed", "pos"


def init_params(specs, generator: torch.Generator, device: DeviceLike = None):
    """Materialise a spec tree on ``device`` (default cuda).

    ``normal`` leaves draw with std ``scale / sqrt(prod(fan-in dims))``,
    ``embed`` and ``pos`` with std ``0.02 * scale``, as float32 normals
    from ``generator`` cast to the leaf dtype; ``zeros`` and ``ones``
    fill.  ``generator`` must live on ``device`` (a CUDA generator draws
    the weights on the card, so no host copy of them is made).  Leaves
    draw in the tree's order, so a seed fixes the whole tree; the numbers
    differ from ``jax.random``'s, so tests that compare with the JAX
    package convert its parameters instead (``convert_params``).
    """
    device = resolve_device(device)

    def leaf(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init not in ("normal", "embed", "pos"):
            raise ValueError(f"unknown init {s.init!r}")
        x = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(_std(s)).to(s.dtype)

    return map_tree(leaf, specs)
