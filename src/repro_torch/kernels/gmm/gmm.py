"""Hand-written CUDA kernel for the GMM background update (K5).

Port of ``repro/kernels/gmm/gmm.py`` (``gmm_update_pallas``).  The kernel
lives in ``csrc/gmm.cu`` (design, rounding and byte bound in its header);
this module builds it on first use, checks every argument, launches on
PyTorch's current stream, and counts launches under ``"gmm_update"`` in
:data:`repro_torch.kernels.launches.LAUNCHES`.

A CUDA tensor always goes to the kernel; anything the kernel does not take
raises.  The plain PyTorch version (``gmm_update_reference``, from
:mod:`.ref`) is re-exported here: it is what a CPU tensor runs and what the
kernel is held against, bit for bit, on the card.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.core.gmm import GMMConfig
from repro_torch.kernels import _build
from repro_torch.kernels.gmm.ref import (  # noqa: F401  (re-export)
    gmm_update_reference)
from repro_torch.kernels.launches import count_launch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "gmm.cu"
LIBRARY = "tangram_gmm"

#: the kernel unrolls this many mixture components in registers
N_COMPONENTS = 3
STATE_KEYS = ("w", "mu", "var")


def library() -> ctypes.CDLL:
    """Build (first call) and load the kernel library."""
    lib = _build.load_library(LIBRARY, [SOURCE])
    if not getattr(lib, "_typed", False):
        fn = lib.tangram_gmm_update
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(state: dict, frame: torch.Tensor, cfg: GMMConfig) -> None:
    name = "gmm_update"
    if cfg.n_components != N_COMPONENTS:
        raise ValueError(f"{name}: the kernel takes {N_COMPONENTS} "
                         f"components, got n_components={cfg.n_components}")
    if frame.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on one CUDA device, got "
                         f"frame on {frame.device}")
    if frame.dim() != 2:
        raise ValueError(f"{name}: frame must be (H, W), got shape "
                         f"{tuple(frame.shape)}")
    want = (*frame.shape, N_COMPONENTS)
    for key, t in [("frame", frame)] + [(k, state[k]) for k in STATE_KEYS]:
        if t.device != frame.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected "
                             f"{frame.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} has unsupported dtype "
                             f"{t.dtype}; the kernel takes torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key != "frame" and tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want} for frame "
                             f"{tuple(frame.shape)}")


def gmm_update_cuda(state: dict, frame: torch.Tensor,
                    cfg: GMMConfig = GMMConfig()
                    ) -> Tuple[dict, torch.Tensor]:
    """K5: state {w, mu, var} (H, W, 3) f32 + frame (H, W) f32 -> (new
    state, foreground mask (H, W) bool), out of place, any H and W."""
    _check(state, frame, cfg)
    device = frame.device
    new = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    fg = torch.empty(frame.shape, dtype=torch.bool, device=device)
    n_pixels = frame.numel()
    if n_pixels == 0:
        return new, fg
    # each constant rounded to float32 once, as PyTorch rounds a Python
    # scalar in the plain version's ops
    lr = cfg.learning_rate
    consts = (1 - lr, lr, cfg.match_sigmas ** 2, cfg.min_var, cfg.init_var,
              cfg.background_ratio)
    fn = library().tangram_gmm_update
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*(state[k].data_ptr() for k in STATE_KEYS), frame.data_ptr(),
                *(new[k].data_ptr() for k in STATE_KEYS), fg.data_ptr(),
                n_pixels, *consts, stream)
    if rc != 0:
        raise RuntimeError(f"tangram_gmm_update launch failed: CUDA error "
                           f"{rc}")
    count_launch("gmm_update")
    return new, fg
