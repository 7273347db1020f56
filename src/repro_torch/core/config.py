"""`ServeConfig`: one declarative record for the serving pipeline.

Port of the single-executor part of ``repro/core/config.py``.  Every field
is a plain value or a registry name (``make_classify`` / ``make_clock`` /
``make_executor`` / ``make_source`` resolve them), so a config
round-trips through JSON with ``to_dict`` / ``from_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import lookup

#: classifier registry for the ``classify`` field (None: one shared queue)
_CLASSIFIERS: dict = {}


def make_classify(name: Optional[str]
                  ) -> Optional[Callable[[Patch], object]]:
    """Classifier-name -> callable (``"slo"`` | ``None``)."""
    if name is None:
        return None
    if not _CLASSIFIERS:
        from repro_torch.core.engine import slo_class
        _CLASSIFIERS["slo"] = slo_class
    return lookup("classifier", _CLASSIFIERS, name)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the single-executor serving pipeline needs beyond data
    and models."""

    # --- batching (invoker pool) ---------------------------------------
    max_canvases: int = 8            # canvas budget per invocation (Eq. 5)
    classify: Optional[str] = None   # None: shared queue; "slo": per-class

    # --- execution ------------------------------------------------------
    executor: str = "device"         # device | async_device
    fuse: bool = False               # fused stitch->embed / decode->gather
    max_inflight: int = 4            # async in-flight bound (device memory)
    clock: str = "virtual"           # virtual | wall
    wall_speed: float = 1.0          # engine seconds per wall second

    # --- ingestion (source layer) ---------------------------------------
    ingestion_window: Optional[int] = None  # backlog bound, in patches

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.wall_speed <= 0:
            raise ValueError(
                f"wall_speed must be positive, got {self.wall_speed}")
        if self.ingestion_window is not None and self.ingestion_window < 1:
            raise ValueError(f"ingestion_window must be >= 1, got "
                             f"{self.ingestion_window}")

    def replace(self, **changes) -> "ServeConfig":
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig fields {sorted(unknown)}")
        return cls(**d)
