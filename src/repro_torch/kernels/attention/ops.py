"""Public entries for flash attention (K6) and flash decode (K7).

Port of ``repro/kernels/attention/ops.py``.  ``impl`` picks the
implementation: ``"cuda"`` launches the hand-written kernel, ``"torch"``
runs the plain version (``mha_reference`` / ``decode_reference``).  The
default follows the device of ``q``, so a CUDA tensor always reaches the
kernel and a CPU tensor (the tests) the plain version; ``impl="cuda"`` on
a CPU tensor raises, and so does the kernel on inputs that require grad
(it has no backward pass; ``launches.refuse_grad``).  The JAX entries'
``block_*`` and ``interpret`` arguments size and emulate the TPU kernel
and have no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.attention.flash import (flash_attention_cuda,
                                                 flash_decode_cuda)
from repro_torch.kernels.attention.ref import decode_reference, mha_reference
from repro_torch.kernels.launches import refuse_grad

IMPLS = ("cuda", "torch")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``None`` -> by device; otherwise a checked name (``"cuda"`` only for
    a CUDA tensor)."""
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from "
                         f"{list(IMPLS)}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"attention impl 'cuda' needs a CUDA tensor, got "
                         f"one on {x.device}")
    return impl


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Kv, D) -> context (B, Sq, H, D)."""
    if resolve_impl(impl, q) == "cuda":
        refuse_grad("flash_attention", q, k, v)
        return flash_attention_cuda(q, k, v, causal=causal,
                                    segment_ids=segment_ids)
    return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: Union[int, torch.Tensor],
                 impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, Smax, Kv, D); positions 0..pos.  ``pos``
    is a host int or a 0-d int32 tensor on q's device, as the JAX entry
    takes a Python int or a traced scalar."""
    if resolve_impl(impl, q) == "cuda":
        refuse_grad("flash_decode", q, k, v)
        return flash_decode_cuda(q, k, v, pos)
    return decode_reference(q, k, v, pos)
