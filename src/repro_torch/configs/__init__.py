"""Arch registry: ``get(arch_id)`` resolves a ported architecture.

Port of ``repro/configs/__init__.py`` for the ids the port runs.  Each
module defines ``ARCH``; the other ids of the JAX registry raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

#: every id of the JAX registry (``repro.configs.ARCH_IDS``)
ARCH_IDS = (
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "minitron-4b",
    "mistral-large-123b",
    "dit-s2",
    "dit-xl2",
    "deit-b",
    "vit-s16",
    "efficientnet-b7",
    "vit-b16",
    "tangram-detector",
)

PORTED = ("minitron-4b", "tangram-detector", "vit-s16", "efficientnet-b7",
          "vit-b16", "deit-b", "dit-s2", "dit-xl2", "deepseek-moe-16b",
          "llama4-scout-17b-a16e")

#: where each unported id is ported
UNPORTED = {
    "mistral-large-123b": "ROADMAP item 14 (weights sharded over cards)",
}


def get(arch_id: str):
    """The ``ARCH`` config of a ported id."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet: "
                                  f"{UNPORTED[arch_id]}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))
    return mod.ARCH
