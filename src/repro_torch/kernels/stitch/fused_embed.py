"""Hand-written CUDA kernels for the fused serving path: K4 stitch->embed
and K3 decode->gather.

Port of ``repro/kernels/stitch/fused_embed.py`` (``stitch_embed_pallas``,
``unstitch_decode_pallas``).  The kernels live in ``csrc/fused_embed.cu``
(design and bounds in its header); this module builds them on first use,
checks every argument, launches on PyTorch's current stream, and counts
launches in :data:`repro_torch.kernels.launches.LAUNCHES`.

A CUDA tensor always goes to the kernel; anything the kernel does not take
raises.  The plain PyTorch versions (``stitch_embed_reference`` /
``unstitch_decode_reference``, from :mod:`.ref`) are re-exported here: they
are what a CPU tensor runs and what the kernels are held against on the
card.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import count_launch
from repro_torch.kernels.stitch.ref import (  # noqa: F401  (re-export)
    stitch_embed_reference, unstitch_decode_reference)
from repro_torch.kernels.stitch.stitch import MAX_RECORDS_PER_CANVAS

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "fused_embed.cu"
LIBRARY = "tangram_fused"

_MAX_GRID_YZ = 65535
_SEGMENT = 32       # tokens of a token row per f32 K4 block (kBM)
_SMEM_LIMIT = 232448    # bytes of shared memory a Hopper block can have
#: the bf16 K4 kernel's tiles (kWgBM, the default BN, kWgBK, kWgStages in
#: the source): tokens and columns of d a block, K step, weight ring depth
WG_TOKENS, WG_COLS, WG_K, WG_STAGES = 128, 192, 64, 3
#: the bf16 K4's block tiles, (tokens, columns of d): the template instances
#: of the source's kernel.  The first is the default, the main path's tile;
#: ``launch/hillclimb.py`` times them all.  Every tile keeps 128 tokens, the
#: two 64-row consumer warpgroups' share, and with them the K order of
#: every sum, so every tile gives the default's bits.
K4_TILES = ((WG_TOKENS, WG_COLS), (WG_TOKENS, 128), (WG_TOKENS, 64))
_REC_BYTES = 20     # a live record in shared memory (slot, x, y, w, h)
_DEC_TILE = 256     # cells a K3 block writes (kDecTile in the source)
#: weight / raw-head dtypes the kernels take -> the C interface's bf16 flag
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """Build (first call) and load the kernel library."""
    lib = _build.load_library(LIBRARY, [SOURCE])
    if not getattr(lib, "_typed", False):
        lib.tangram_stitch_embed.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.tangram_unstitch_decode.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        for fn in (lib.tangram_stitch_embed, lib.tangram_unstitch_decode):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def k4_tile(tile=None) -> tuple:
    """The bf16 K4's block tile: ``None`` is the default (the first of
    :data:`K4_TILES`); any other tile must be one of them."""
    if tile is None:
        return K4_TILES[0]
    tile = tuple(tile)
    if tile not in K4_TILES:
        raise ValueError(f"K4 tile {tile} is not one of {K4_TILES}")
    return tile


def wgmma_plan(b: int, seq: int, d: int, k: int, patch: int, tile=None):
    """Grid and dynamic shared-memory bytes of the bf16 K4 launch at
    ``tile`` (:func:`k4_tile`: (tokens, columns) a block), as the source's
    ``WgLayout`` lays a block out: the A tile (``WG_TOKENS`` x ``WG_K``
    bf16), the weight ring (``WG_STAGES`` x ``WG_K`` x columns bf16), the
    segment table (``WG_TOKENS * patch`` int4), ``k`` live records, 2
    barriers a stage, the live count and 1024 bytes of alignment slack."""
    tokens, cols = k4_tile(tile)
    ring = (tokens * WG_K + WG_STAGES * WG_K * cols) * 2
    live_end = ring + tokens * patch * 16 + k * _REC_BYTES
    smem = -(-live_end // 8) * 8 + 2 * WG_STAGES * 8 + 8 + 1024
    grid = (-(-d // cols), -(-seq // tokens), b)
    return grid, smem


def check_wgmma_shape(name: str, b: int, seq: int, kdim: int, d: int, k: int,
                      patch: int, slot_elems: int, tile=None) -> None:
    """Raise on what the bf16 K4 kernel does not take: a tile outside
    :data:`K4_TILES`, K in steps of 64 (``patch**2 * C``), weight rows a
    multiple of 16 bytes (TMA), slot offsets in int32, and a block within
    the card's shared memory."""
    if kdim % WG_K:
        raise ValueError(f"{name}: the bf16 kernel takes K = patch^2 * C in "
                         f"steps of {WG_K}, got {kdim}")
    if d % 8:
        raise ValueError(f"{name}: the bf16 kernel takes d a multiple of 8 "
                         f"(16-byte weight rows), got {d}")
    if slot_elems >= 2**31:
        raise ValueError(f"{name}: {slot_elems} slot elements exceed int32 "
                         f"offsets")
    _, smem = wgmma_plan(b, seq, d, k, patch, tile)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {k} records per canvas at patch {patch} "
                         f"need {smem} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")


def decode_plan(num_patches: int, side_m: int, side_n: int):
    """Grid of the K3 launch and whether it stores 16 bytes a lane, as the
    source's ``launch_unstitch_decode`` launches it: one block per (output
    slot, tile of ``_DEC_TILE`` cells), the vector stores when the cells
    of a slot are a multiple of 4.  Raises when the tiles overflow the
    grid's y dimension."""
    cells = side_m * side_n
    tiles = -(-cells // _DEC_TILE)
    if tiles > _MAX_GRID_YZ:
        raise ValueError(f"unstitch_decode: {side_m}x{side_n} cells exceed "
                         f"{_MAX_GRID_YZ} tiles of {_DEC_TILE}")
    return (num_patches, tiles), cells % 4 == 0


def _check_tensor(name: str, what: str, t: torch.Tensor, device: torch.device,
                  dim: int, dtypes) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} on {t.device}, expected {device}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {dim}-d "
                         f"tensor, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} has unsupported dtype {t.dtype}; "
                         f"the kernel takes {[str(d) for d in dtypes]}")


def _check_records(name: str, records: torch.Tensor,
                   device: torch.device) -> None:
    _check_tensor(name, "records", records, device, 3, (torch.int32,))
    if records.shape[-1] != 6:
        raise ValueError(f"{name}: records must be (B, K, 6), got "
                         f"{tuple(records.shape)}")
    if records.shape[1] > MAX_RECORDS_PER_CANVAS:
        raise ValueError(f"{name}: {records.shape[1]} records per canvas "
                         f"exceeds {MAX_RECORDS_PER_CANVAS}")
    if records.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {records.shape[0]} canvases exceed "
                         f"{_MAX_GRID_YZ}")


def _cuda_device(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on one CUDA device, got "
                         f"{t.device}")
    return t.device


def _run(fn, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def stitch_embed_cuda(patch_pixels: torch.Tensor, records: torch.Tensor,
                      kernel: torch.Tensor, bias: torch.Tensor,
                      m: int, n: int, patch: int, tile=None) -> torch.Tensor:
    """K4: slots (P, Hmax, Wmax, C) f32 + records (B, K, 6) + kernel
    (patch*patch*C, d) + bias (d,) -> tokens (B, seq, d) in the kernel's
    dtype (float32 or bfloat16), without a canvas in device memory.
    ``tile``: the bf16 kernel's block tile (:func:`k4_tile`; ``None`` is
    the default); the float32 kernel has one tile and takes only ``None``.

    The valid records must keep the kernels' contract (inside the canvas,
    within the slot, slot index below P), which the kernel does not
    re-check: :func:`repro_torch.kernels.stitch.ops.check_records`."""
    name = "stitch_embed"
    _, cols = k4_tile(tile)
    device = _cuda_device(name, patch_pixels)
    _check_tensor(name, "slots", patch_pixels, device, 4, (torch.float32,))
    _check_records(name, records, device)
    _check_tensor(name, "kernel", kernel, device, 2, tuple(_BF16_FLAG))
    _check_tensor(name, "bias", bias, device, 1, (kernel.dtype,))
    p, hmax, wmax, c = patch_pixels.shape
    b, k, _ = records.shape
    d = kernel.shape[1]
    if m % patch or n % patch:
        raise ValueError(f"{name}: canvas {m}x{n} is not a multiple of the "
                         f"patch {patch}")
    if hmax > m or wmax > n:
        raise ValueError(f"{name}: slot {hmax}x{wmax} exceeds canvas {m}x{n}")
    if kernel.shape[0] != patch * patch * c or bias.shape[0] != d:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit patch {patch}, "
                         f"{c} channels")
    side_m, side_n = m // patch, n // patch
    if side_m * -(-side_n // _SEGMENT) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {side_m}x{side_n} token grid too large")
    if kernel.dtype != torch.bfloat16 and tile is not None:
        raise ValueError(f"{name}: the float32 kernel has one tile; got "
                         f"tile {tile}")
    if kernel.dtype == torch.bfloat16:
        check_wgmma_shape(name, b, side_m * side_n, kernel.shape[0], d, k,
                          patch, patch_pixels.numel(), tile)
        if kernel.data_ptr() % 16:
            raise ValueError(f"{name}: kernel is not 16-byte aligned (TMA)")
    if b == 0 or k == 0 or p == 0:
        # empty packing: the embed of an all-zero canvas is the bias
        return bias.expand(b, side_m * side_n, d).contiguous()
    out = torch.empty((b, side_m * side_n, d), dtype=kernel.dtype,
                      device=device)
    _run(library().tangram_stitch_embed, device, patch_pixels.data_ptr(),
         records.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
         out.data_ptr(), hmax, wmax, c, b, k, m, n, patch, d,
         _BF16_FLAG[kernel.dtype], cols)
    count_launch("stitch_embed")
    return out


def unstitch_decode_cuda(raw: torch.Tensor, records: torch.Tensor,
                         patch: int, num_patches: int) -> torch.Tensor:
    """K3: raw head (B, side_m, side_n, 5) in float32 or bfloat16 + records
    -> (num_patches, side_m, side_n, 5) float32 decoded per-slot grids.

    One launch, slot-major, into ``torch.empty``: the kernel writes every
    output byte once.  A slot's owner is the last valid record, in (b, k)
    order, that names it (the reference's answer when two records name one
    slot); its cells are decoded where their centre lies in the owner's
    placement and zero elsewhere, and a slot no valid record names is zero.
    Records keep K4's contract."""
    name = "unstitch_decode"
    device = _cuda_device(name, raw)
    _check_tensor(name, "raw", raw, device, 4, tuple(_BF16_FLAG))
    _check_records(name, records, device)
    b, side_m, side_n, ch = raw.shape
    k = records.shape[1]
    if ch != 5:
        raise ValueError(f"{name}: raw head must have 5 channels, got {ch}")
    if records.shape[0] != b:
        raise ValueError(f"{name}: {records.shape[0]} record rows for {b} "
                         f"canvases")
    if num_patches == 0 or b == 0 or k == 0:
        return torch.zeros((num_patches, side_m, side_n, 5),
                           dtype=torch.float32, device=device)
    decode_plan(num_patches, side_m, side_n)
    out = torch.empty((num_patches, side_m, side_n, 5), dtype=torch.float32,
                      device=device)     # every byte written by the kernel
    _run(library().tangram_unstitch_decode, device, raw.data_ptr(),
         records.data_ptr(), out.data_ptr(), b, k, side_m, side_n,
         num_patches, patch, _BF16_FLAG[raw.dtype])
    count_launch("unstitch_decode")
    return out
