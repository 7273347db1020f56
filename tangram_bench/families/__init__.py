"""Detector families: what the benchmark needs to know of a trunk's
architecture, one module a family, looked up by the configuration's
``family`` (``vit`` where the file names none).

A family module provides:

* ``KEYS``: the configuration keys that must equal the registry model's
  ``DetectorConfig`` attributes (``harness.detector_config``);
* ``leaf_specs(cfg)``: ``(path, shape, init, fan_in)`` of every weight
  leaf in tree order, which ``weights.make_weights`` draws and
  ``weights.n_params`` counts;
* ``detector_raw(tokens, weights, side, eps, matmul)``: embedded tokens
  (B, S, d) -> raw head (B, side, side, 5), the plain float32 reference
  of the trunk and head, every product through ``matmul`` so that the
  bf16 yardstick and the fp8 control apply unchanged;
* ``flops_per_canvas(cfg)``: multiply-adds x 2 of one canvas, which
  ``counters.detector_flops_per_canvas`` returns.

Every family shares the rest of the fused path's reference
(``reference.py``: ``plan``, ``stitch``, ``embed``, ``decode_gather``,
``route``, ``layernorm``, the ``mm*`` products, ``full_float32``), the
objectness calibration (``weights.set_objectness``) and K4's counts
(``counters.k4_work``).
"""
from __future__ import annotations

import importlib
import pathlib
from types import ModuleType

DEFAULT = "vit"


def load(cfg: dict) -> ModuleType:
    """The family module that ``cfg`` names; stops set-up, naming the
    family files there are, when there is none of that name."""
    name = cfg.get("family", DEFAULT)
    module = f"{__name__}.{name}"
    if isinstance(name, str) and name.isidentifier():
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    found = sorted(p.stem for p in pathlib.Path(__file__).parent.glob("*.py")
                   if p.stem != "__init__")
    raise SystemExit(f"{cfg.get('name', '?')}: unknown family {name!r}; "
                     f"tangram_bench/families has {found}")
