"""Post-training weight quantization: fp parameters -> int8-resident tree.

Port of ``repro/models/quantize.py``.  ``quantize_params(quant_specs,
fp_params)`` walks the quantized spec tree (built with
``quant_weights=True``) alongside a floating-point parameter tree and
emits int8 weights with float32 scales.  Each scale is
``amax(|k|) / 127 + 1e-12`` over the fan-in axes, and each weight
``clip(round(k / scale), -127, 127)``; ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the values equal the JAX package's bit
for bit.

The JAX package reads the fan-in axes from the specs' logical axis names:
every kernel axis the scale's spec does not name.  The port's specs carry
no axis names, so an int8 kernel's spec states them: its ``fan_in_axes``
(an MoE expert kernel (E, in, out) with scales (E, out) gives ``(1,)``),
or, when it gives none, the leading axes the scale lacks (a dense (in,
out) kernel; the port's trees hold one entry per layer, with no scanned
``layers`` axis in front).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.param import ParamSpec


def quantize_kernel(kernel: torch.Tensor,
                    reduce: Union[int, Tuple[int, ...]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scales) of ``kernel``, reduced over the axes
    ``reduce`` (an int n: the leading n axes)."""
    axes = tuple(range(reduce)) if isinstance(reduce, int) else reduce
    k32 = kernel.to(torch.float32)
    scale = k32.abs().amax(dim=axes, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(k32 / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axes)


def _quantize_kernel(kernel: torch.Tensor, q_spec: ParamSpec,
                     s_spec: ParamSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    axes = q_spec.fan_in_axes
    if axes:
        kept = tuple(n for i, n in enumerate(q_spec.shape) if i not in axes)
        if kept != s_spec.shape:
            raise ValueError(f"scale {s_spec.shape} is not the kernel "
                             f"{q_spec.shape} without its fan-in axes "
                             f"{axes}")
    else:
        n_reduce = len(q_spec.shape) - len(s_spec.shape)
        if n_reduce < 1 or q_spec.shape[n_reduce:] != s_spec.shape:
            raise ValueError(f"scale {s_spec.shape} does not cover the "
                             f"trailing axes of the kernel {q_spec.shape}")
        axes = tuple(range(n_reduce))
    if tuple(kernel.shape) != q_spec.shape:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match its "
                         f"spec {q_spec.shape}")
    return quantize_kernel(kernel, axes)


def quantize_params(quant_specs, fp_params):
    """Map a floating-point parameter tree onto the structure of
    ``quant_specs``: ``{q, scale}`` and ``{kernel_q, kernel_scale[, bias]}``
    nodes are quantized from the fp weight, every other leaf is cast to
    its spec's dtype (on the fp tensor's device)."""
    def walk(spec_node, fp_node):
        if isinstance(spec_node, ParamSpec):
            return fp_node.to(spec_node.dtype)
        if isinstance(spec_node, list):
            return [walk(s, f) for s, f in zip(spec_node, fp_node)]
        if isinstance(spec_node, dict):
            if isinstance(spec_node.get("q"), ParamSpec) \
                    and "scale" in spec_node:
                q, s = _quantize_kernel(fp_node, spec_node["q"],
                                        spec_node["scale"])
                return {"q": q, "scale": s}
            if "kernel_q" in spec_node:
                q, s = _quantize_kernel(fp_node["kernel"],
                                        spec_node["kernel_q"],
                                        spec_node["kernel_scale"])
                out = {"kernel_q": q, "kernel_scale": s}
                if "bias" in spec_node:
                    out["bias"] = fp_node["bias"].to(spec_node["bias"].dtype)
                return out
            return {k: walk(v, fp_node[k]) for k, v in spec_node.items()}
        raise TypeError(type(spec_node))
    return walk(quant_specs, fp_params)
