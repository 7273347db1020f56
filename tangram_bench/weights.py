"""The detector's weights, drawn on the device from ``--seed``.

One ``torch.randn`` fills a flat float32 buffer for every leaf at once;
each leaf's slice is scaled to its init (a kernel's std ``1 /
sqrt(fan_in)``, the two projections that write into the residual stream,
``wo`` and ``fc2``, a further ``1 / sqrt(2 n_layers)`` as GPT-2 scales
them, so that a random trunk stays as well conditioned on every seed;
biases and position embeddings ``0.02``, norm scales ``1 + 0.02 N``),
the buffer is rounded once to the served dtype, and the leaves
are views into it, each starting on a 128-byte boundary.  The leaves
are those of the configuration's family (``families/<family>.py``'s
``leaf_specs``), in the detector's published layout (nested dicts, the
layers a list), which both the program and the reference read.
:func:`set_objectness` then shifts the head's objectness bias so that a
share of the cells of a reference canvas routes a detection, as a sparse
scene would (random weights put every cell of a canvas near one
objectness otherwise).
"""
from __future__ import annotations

import math

import torch

from tangram_bench import families

_ALIGN = 64     # elements (128 bytes in bf16)


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape)
               for _, shape, _, _ in families.load(cfg).leaf_specs(cfg))


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def make_weights(cfg: dict, seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tree of ``dtype`` views into one buffer, drawn from ``seed``."""
    specs = families.load(cfg).leaf_specs(cfg)
    offsets, total = [], 0
    for _, shape, _, _ in specs:
        offsets.append(total)
        total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    for (path, shape, init, fan_in), off in zip(specs, offsets):
        part = flat[off:off + math.prod(shape)]
        if init == "w":
            part.mul_(1.0 / math.sqrt(fan_in))
        elif init == "out":
            part.mul_(1.0 / math.sqrt(fan_in * 2 * cfg["n_layers"]))
        else:
            part.mul_(0.02)
            if init == "scale":
                part.add_(1.0)
    served = flat.to(dtype)
    del flat
    tree: dict = {}
    for (path, shape, _, _), off in zip(specs, offsets):
        _put(tree, path, served[off:off + math.prod(shape)].view(shape))
    return tree


def set_objectness(weights: dict, raw: torch.Tensor, share: float) -> float:
    """Shift the objectness bias by the ``1 - share`` quantile of the
    objectness logits of ``raw`` (cells, 5): the float32 reference's head
    on routable cells of real canvases, so that ``share`` of those cells
    clear the 0.5 threshold.  Returns the shift."""
    logits = raw[..., 0].reshape(-1).to(torch.float32)
    shift = float(torch.quantile(logits, 1.0 - share))
    bias = weights["det_head"]["bias"]
    bias[0] = (bias[0].to(torch.float32) - shift).to(bias.dtype)
    return shift
