"""Model registry: named :class:`ModelSpec` records behind ``make_model``.

Port of ``repro/core/models.py`` with the JAX registry's entries: the
paper's detector ``tangram`` (ViT-B/32 trunk on 1024^2 canvases, bf16),
``vit_s16`` (the ViT-S/16 trunk at patch 16), ``efficientnet_b7`` (a
transformer trunk sized to B7's compute class, B7's weight economics),
the int8-resident variants ``tangram_int8`` and ``vit_s16_int8``, and
the port's own ``vitdet_l`` (ViTDet-L, ``configs/vitdet_l.py``).  A
spec carries identity, canvas geometry, weight economics
(``weight_bytes`` / ``load_s``), a latency profile (explicit, or the
analytical model over the trunk dims on an H100), and :meth:`build`,
which makes a servable detector on a device.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import DetectorConfig
from repro_torch.core.latency import LatencyTable, detector_latency_model
from repro_torch.core.registry import lookup
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["ModelSpec", "make_model", "register_model", "model_names"]

#: bytes per parameter by param dtype (weight-size estimates)
_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

#: default host->device weight-load bandwidth (PCIe gen4 x16-ish)
_DEFAULT_LOAD_BW = 12.5e9


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One servable model: identity, geometry, economics, and builder.

    ``canvas_m`` / ``canvas_n`` / ``weight_bytes`` default from ``arch``;
    specs without an ``arch`` must state them and carry a ``table``.
    """

    name: str
    arch: Optional[DetectorConfig] = None
    canvas_m: Optional[int] = None
    canvas_n: Optional[int] = None
    weight_bytes: Optional[float] = None
    table: Optional[LatencyTable] = None
    load_bw: float = _DEFAULT_LOAD_BW
    #: serving precision: None serves the arch's param dtype; "int8"
    #: serves int8-resident trunk weights (1 byte a parameter in the
    #: economics, its own latency profile, and :meth:`build` quantizes
    #: the fp init through ``models/quantize.py``)
    dtype: Optional[str] = None
    description: str = ""

    def __post_init__(self):
        if self.dtype not in (None, "int8"):
            raise ValueError(f"ModelSpec {self.name!r}: unsupported dtype "
                             f"{self.dtype!r} (None or 'int8')")
        if self.arch is not None:
            if self.canvas_m is None:
                object.__setattr__(self, "canvas_m", self.arch.canvas)
            if self.canvas_n is None:
                object.__setattr__(self, "canvas_n", self.arch.canvas)
            if self.weight_bytes is None:
                per_param = (1 if self.dtype == "int8" else
                             _DTYPE_BYTES.get(self.arch.param_dtype, 4))
                object.__setattr__(self, "weight_bytes",
                                   float(self.arch.n_params * per_param))
        if self.canvas_m is None or self.canvas_n is None:
            raise ValueError(f"ModelSpec {self.name!r} needs canvas "
                             f"geometry (canvas_m/canvas_n or an arch)")
        if self.weight_bytes is None:
            raise ValueError(f"ModelSpec {self.name!r} needs weight_bytes "
                             f"(explicit or derivable from an arch)")
        if self.table is None and self.arch is None:
            raise ValueError(f"ModelSpec {self.name!r} needs a latency "
                             f"source (an explicit table or an arch)")
        if self.load_bw <= 0:
            raise ValueError(f"load_bw must be positive, got {self.load_bw}")

    @property
    def load_s(self) -> float:
        """Modeled seconds to move the weights onto the card."""
        return float(self.weight_bytes) / self.load_bw

    def latency_table(self, max_batch: int = 16,
                      slack_sigmas: float = 3.0) -> LatencyTable:
        """The explicit ``table``, else the analytical roofline model over
        the trunk dims at this spec's canvas geometry on one H100."""
        if self.table is not None:
            return self.table
        a = self.arch
        model = detector_latency_model(
            self.canvas_m, self.canvas_n, patch=a.patch,
            n_layers=a.n_layers, d_model=a.d_model, d_ff=a.d_ff)
        if self.dtype == "int8":
            # the JAX package's factor, kept so that the two packages'
            # profiles agree: half the FLOP time and half the weight
            # bytes.  The weight bytes are halved in HBM, but the port's
            # int8 trunk dequantizes to bf16 and runs bf16 tensor-core
            # products, so the halved FLOP time is the model's, not the
            # card's (PERF.md holds the measured trunk time beside it)
            model = dataclasses.replace(
                model, flops_per_canvas=model.flops_per_canvas * 0.5,
                weight_bytes=model.weight_bytes * 0.5)
        return model.build_table(max_batch, slack_sigmas=slack_sigmas)

    def reduced_arch(self, canvas: int) -> DetectorConfig:
        """A small, CPU-runnable stand-in for the trunk: same family and
        patching, dims scaled down."""
        a = self.arch
        if a is None:
            raise ValueError(f"ModelSpec {self.name!r} has no arch to build")
        patch = a.patch if canvas % a.patch == 0 else 32
        while canvas % patch:
            patch //= 2
        d_model = max(32, a.d_model // 12)
        cfg = DetectorConfig(
            name=f"{self.name}-reduced", canvas=canvas, patch=patch,
            n_layers=max(1, a.n_layers // 6), d_model=d_model,
            n_heads=4, d_ff=2 * d_model,
            param_dtype="float32", compute_dtype="float32")
        if a.plain:
            return cfg
        # a ViTDet trunk keeps its mechanism: windows of 3 (so that a grid
        # of a power-of-two side is padded), every other block global
        return dataclasses.replace(
            cfg, window=min(a.window, 3), global_every=min(a.global_every, 2),
            rel_pos=a.rel_pos, attn_bias=a.attn_bias, gelu=a.gelu)

    def build(self, canvas: Optional[int] = None, reduced: bool = True,
              device: DeviceLike = None):
        """A servable detector for this spec on ``device`` (default cuda).

        Returns ``(cfg, params, serve_fn)``.  ``reduced=True`` builds the
        scaled-down trunk at ``canvas`` (default 256); ``reduced=False``
        the full trunk at the spec's native canvas.  Weights come from a
        ``torch.Generator`` seeded by the model name.

        ``dtype="int8"`` specs draw the full-precision weights of their
        base model (seeded by the name minus ``_int8``, so ``tangram_int8``
        is ``tangram`` quantized) and quantize them through
        ``models/quantize.py``; the returned cfg has ``quant_weights=True``.
        """
        from repro_torch.models import detector as detector_lib
        from repro_torch.models.quantize import quantize_params

        dev = resolve_device(device)
        if reduced:
            cfg = self.reduced_arch(canvas or 256)
        else:
            cfg = (self.arch if canvas is None
                   else dataclasses.replace(self.arch, canvas=canvas))
        int8 = self.dtype == "int8"
        seed_name = (self.name[:-len("_int8")]
                     if int8 and self.name.endswith("_int8") else self.name)
        gen = torch.Generator().manual_seed(
            zlib.crc32(seed_name.encode()) & 0x7FFFFFFF)
        cfg = dataclasses.replace(cfg, quant_weights=False)
        params = detector_lib.init_params(cfg, gen, dev)
        if int8:
            cfg = dataclasses.replace(cfg, quant_weights=True)
            params = quantize_params(detector_lib.param_specs(cfg), params)
        return cfg, params, detector_lib.serve_fn(cfg)


_MODELS: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    """Register (or replace: last registration wins) a named spec."""
    _MODELS[spec.name] = spec
    return spec


_seeded = False


def _ensure_seeded():
    global _seeded
    if _seeded:
        return
    _seeded = True
    from repro_torch.configs import (efficientnet_b7, tangram_detector,
                                     vit_s16, vitdet_l)
    from repro_torch.models.efficientnet import count_params

    register_model(ModelSpec(
        name="tangram", arch=tangram_detector.ARCH,
        description="the paper's detector (ViT-B/32 trunk, 1024^2 canvas)"))
    register_model(ModelSpec(
        name="tangram_int8", arch=tangram_detector.ARCH, dtype="int8",
        description="tangram with int8-resident trunk weights "
                    "(quantized serve path)"))

    # a lighter detector on the ViT-S/16 trunk (patch 16: a 64x64 token
    # grid on a 1024^2 canvas): the choice for tight SLO classes
    v = vit_s16.ARCH
    vit_s16_det = DetectorConfig(
        name="vit-s16-det", canvas=1024, patch=v.patch,
        n_layers=v.n_layers, d_model=v.d_model, n_heads=v.n_heads,
        d_ff=v.d_ff, param_dtype="bfloat16", compute_dtype="bfloat16")
    register_model(ModelSpec(
        name="vit_s16", arch=vit_s16_det,
        description="detector on the ViT-S/16 trunk (light, fine patches)"))
    register_model(ModelSpec(
        name="vit_s16_int8", arch=vit_s16_det, dtype="int8",
        description="vit_s16 with int8-resident trunk weights"))

    # EfficientNet-B7-class detector: the detector head runs on a ViT
    # trunk, so the servable build is a transformer sized to B7's compute
    # class, and the weight economics come from the conv net's count
    e = efficientnet_b7.ARCH
    register_model(ModelSpec(
        name="efficientnet_b7",
        arch=DetectorConfig(
            name="efficientnet-b7-det", canvas=1024, patch=32,
            n_layers=18, d_model=512, n_heads=8, d_ff=2048,
            param_dtype="bfloat16", compute_dtype="bfloat16"),
        weight_bytes=float(count_params(e)
                           * _DTYPE_BYTES.get(e.param_dtype, 4)),
        description="EfficientNet-B7-class detector (conv-net weight "
                    "economics, transformer substitute trunk)"))

    # ViTDet-L (arXiv:2203.16527) at its 1024^2 input: windowed and
    # global attention with decomposed relative positions; the JAX
    # registry has no such trunk
    register_model(ModelSpec(
        name="vitdet_l", arch=vitdet_l.ARCH,
        description="ViTDet-L (ViT-L/16 trunk, 14x14 windows, 4 global "
                    "blocks, relative positions, 1024^2 canvas)"))


def make_model(name: str) -> ModelSpec:
    """Model-name -> :class:`ModelSpec` with the unified unknown-name
    error."""
    _ensure_seeded()
    return lookup("model", _MODELS, name)


def model_names() -> Tuple[str, ...]:
    """Registered model names."""
    _ensure_seeded()
    return tuple(sorted(_MODELS))
