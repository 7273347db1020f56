"""`ServeConfig`: one declarative record for the serving pipeline.

Port of ``repro/core/config.py``.  Every field is a plain value or a
registry name (``make_classify`` / ``make_clock`` / ``make_executor`` /
``make_source`` resolve them), so a config round-trips through JSON with
``to_dict`` / ``from_dict`` (the nested ``AIMDConfig`` included).

The fleet's fields (``shards``, ``planner``, ``parallel``) are kept so
that a JAX config loads here, but nothing in the port runs them yet:
``TangramScheduler`` refuses each with ``NotImplementedError`` naming
ROADMAP item 11, as the serve driver does.  Model routing
(``model`` / ``model_map``: :meth:`ServeConfig.resolve_model`), worker
pools (``n_workers``, ``placement``) and the online latency table run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core.adaptive import AIMDConfig
from repro_torch.core.partitioning import Patch
from repro_torch.core.registry import lookup

#: ServeConfig fields the port does not run yet -> the ROADMAP item that
#: ports them (the serve driver's flags and ``TangramScheduler`` name it)
UNPORTED = {
    "shards": "ROADMAP queue 1, item 11 (fleet sharding)",
    "parallel": "ROADMAP queue 1, item 11 (fleet sharding)",
    "planner": "ROADMAP queue 1, item 11 (fleet sharding)",
}

#: classifier registry for the ``classify`` field (None: one shared
#: queue); register project classifiers so configs stay serializable
_CLASSIFIERS: dict = {}


def register_classify(name: str, fn: Callable[[Patch], object]) -> None:
    _CLASSIFIERS[name] = fn


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
    """Everything the serving pipeline needs beyond data and models."""

    # --- batching (invoker pool) ---------------------------------------
    max_canvases: int = 8            # canvas budget per invocation (Eq. 5)
    incremental: bool = True         # live PackState vs literal restitch
    classify: Optional[str] = None   # None: shared queue; "slo": per-class
    adaptive: Optional[AIMDConfig] = None  # AIMD controller on the pool

    # --- execution ------------------------------------------------------
    executor: str = "sim"            # sim | device | async_device
    fuse: bool = False               # fused stitch->embed / decode->gather
    quantize: bool = False           # serve int8-resident weights
    max_inflight: int = 4            # async in-flight bound (device memory)
    clock: str = "virtual"           # virtual | wall
    wall_speed: float = 1.0          # engine seconds per wall second
    check_invariants: bool = False

    # --- worker pool ------------------------------------------------------
    n_workers: int = 1
    placement: Optional[str] = None  # least | round | affinity | model
                                     # (None: least)

    # --- fleet sharding (ROADMAP item 11) ---------------------------------
    shards: Optional[int] = None
    planner: Optional[str] = None    # cost | equal
    parallel: bool = False

    # --- models (registry names; see repro_torch.core.models) --------------
    model: Optional[str] = None      # default model for every class (None:
                                     # the single-model pipeline)
    model_map: Optional[Dict[str, str]] = None
                                     # SLO class (as str) -> model name;
                                     # unmapped classes fall back to model

    # --- latency estimator ------------------------------------------------
    online_latency: bool = False     # OnlineLatencyTable feedback loop

    # --- ingestion (source layer) ---------------------------------------
    source: str = "trace"            # trace | synthetic | file
    ingestion_window: Optional[int] = None  # backlog bound, in patches

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.planner is not None and self.shards is None:
            raise ValueError("planner requires shards to be set")
        if self.parallel and self.shards is None:
            raise ValueError("parallel requires shards to be set")
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

    @property
    def multi_model(self) -> bool:
        """True when a default model and/or a class->model map is set."""
        return self.model is not None or bool(self.model_map)

    def resolve_model(self, key: object) -> Optional[str]:
        """SLO class key -> registry model name.  Keys match ``model_map``
        by their ``str()`` (JSON object keys are strings); misses fall
        back to the default ``model``."""
        if self.model_map:
            name = self.model_map.get(str(key))
            if name is not None:
                return name
        return self.model

    def model_names(self) -> list:
        """Every registry model this config names (sorted)."""
        names = set(self.model_map.values()) if self.model_map else set()
        if self.model is not None:
            names.add(self.model)
        return sorted(names)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        d = dict(d)
        if isinstance(d.get("adaptive"), dict):
            d["adaptive"] = AIMDConfig(**d["adaptive"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig fields {sorted(unknown)}")
        return cls(**d)
