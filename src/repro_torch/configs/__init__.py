"""Arch registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/__init__.py``.  Each module defines ``ARCH`` (the
model config), ``SHAPES`` (its shape set), and optionally ``OVERRIDES``
(per-shape plan knobs: accum steps, sharding overlay flags).

:func:`get` returns the model config (``ARCH``), as the port's callers
have taken it since the first slice; the JAX ``get`` returns the
:class:`ArchSpec`, which here is :func:`arch_spec`.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.config import ShapeConfig

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
    # the paper's own serving model
    "tangram-detector",
)


@dataclasses.dataclass(frozen=True)
class CellOverride:
    accum_steps: int = 1
    fsdp: bool = False
    sequence_parallel: bool = False      # KV-cache seq over "model" (decode)
    act_seq: bool = False                # activation seq-sharding (train)
    remat_policy: Optional[str] = None   # override model remat policy
    extra_rules: Optional[dict] = None   # arch-specific rule overlay
    quant_weights: bool = False          # int8-resident weights (serving)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: object
    shapes: Tuple[ShapeConfig, ...]
    overrides: Dict[str, CellOverride]

    def override(self, shape_name: str) -> CellOverride:
        return self.overrides.get(shape_name, CellOverride())


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


def get(arch_id: str):
    """The ``ARCH`` model config of ``arch_id``."""
    return _module(arch_id).ARCH


def arch_spec(arch_id: str) -> ArchSpec:
    """The :class:`ArchSpec` of ``arch_id``: the JAX registry's ``get``."""
    mod = _module(arch_id)
    return ArchSpec(arch_id, mod.ARCH, tuple(mod.SHAPES),
                    getattr(mod, "OVERRIDES", {}))


def all_cells():
    """Yield every (arch_id, shape) dry-run cell (40 for the pool)."""
    for arch_id in ARCH_IDS:
        if arch_id == "tangram-detector":
            continue
        spec = arch_spec(arch_id)
        for shape in spec.shapes:
            yield arch_id, shape
