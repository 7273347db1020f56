"""Fault-tolerant checkpointing: atomic commit, resume-from-latest, keep-k.

Port of ``repro/training/checkpoint.py``, with the same layout on disk::

    <dir>/step_00000100.tmp/     (being written)
    <dir>/step_00000100/         (committed: atomic rename after manifest)
        manifest.json            {step, n_leaves, treedef, leaves: [{shape,
                                  dtype}]}
        leaf_00000.npy ...

Leaves are taken in ``jax.tree_util``'s order (dict keys sorted, lists in
order: ``param.sorted_leaves``), and dtypes numpy cannot hold (bfloat16)
are stored widened to float32 with the original dtype recorded, so a
checkpoint of the same tree written by either package restores in the
other.  ``restore`` places each leaf on the device and in the dtype of the
like-tree's leaf (or on ``device``), where the reference takes a sharding
tree.  The commit protocol (tmpdir + fsync'd manifest + rename) is the
load-bearing part.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.param import replace_leaves, sorted_leaves

#: dtypes stored as they are; every other dtype is stored as float32
_NATIVE = ("float32", "float64", "int32", "int64", "uint8", "bool", "int8",
           "float16")


def _treedef(tree) -> str:
    """The tree's structure as ``jax.tree_util``'s treedef prints it."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def save(directory: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` and keep the newest ``keep``
    committed steps; returns the committed directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = sorted_leaves(tree)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": f"PyTreeDef({_treedef(tree)})", "leaves": []}
    for i, leaf in enumerate(leaves):
        stored_dtype = str(leaf.dtype).removeprefix("torch.")
        t = leaf.detach().cpu()
        if stored_dtype not in _NATIVE:
            t = t.to(torch.float32)        # bf16 etc: store widened
        arr = t.numpy()
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": stored_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit

    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int) -> None:
    for s in committed_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str) -> List[int]:
    """Steps with a committed manifest, ascending; a ``.tmp`` (torn) write
    is invisible."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like_tree,
            device: DeviceLike = None):
    """Step ``step`` in the structure of ``like_tree``, each leaf in its
    like leaf's dtype and on its device (on ``device`` when given).
    Raises ``ValueError`` if the leaf count or a shape differs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = sorted_leaves(like_tree)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"tree structure mismatch: checkpoint has "
                         f"{manifest['n_leaves']} leaves, the tree "
                         f"{len(like)}")
    target = None if device is None else resolve_device(device)
    out = []
    for i, ref in enumerate(like):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: ckpt {arr.shape} vs model "
                             f"{tuple(ref.shape)}")
        out.append(torch.from_numpy(arr).to(
            device=target or ref.device, dtype=ref.dtype))
    return replace_leaves(like_tree, out)


def restore_latest(directory: str, like_tree, device: DeviceLike = None
                   ) -> Tuple[object, Optional[int]]:
    """(tree, step) of the latest committed step, or (None, None)."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like_tree, device), step
