"""Hand-written CUDA kernels for batched canvas stitch (K1) and unstitch (K2).

Port of ``repro/kernels/stitch/stitch.py`` (``stitch_pallas``,
``unstitch_pallas``).  The kernels live in ``csrc/stitch.cu`` (design and
byte bound in its header); this module builds them on first use, checks
every argument, plans K1's launch (:func:`stitch_plan`), launches on
PyTorch's current stream, and counts launches in
:data:`repro_torch.kernels.launches.LAUNCHES` (re-exported here).

A CUDA tensor always goes to the kernel; anything the kernel does not take
raises.  The plain PyTorch versions (``stitch_reference`` /
``unstitch_reference``, from :mod:`.ref`) are re-exported here: they are
what a CPU tensor runs and what the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import (  # noqa: F401  (re-export)
    LAUNCHES, count_launch, reset_launches)
from repro_torch.kernels.stitch.ref import (  # noqa: F401  (re-export)
    stitch_reference, unstitch_reference)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stitch.cu"
LIBRARY = "tangram_stitch"

#: K1 keeps a list of one canvas's records in shared memory and names a
#: pixel's owner by its record index in int16 (``kMaxRecords`` in the source)
MAX_RECORDS_PER_CANVAS = 2048
_MAX_GRID_Y = 65535
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block can have
#: K1 plans at least four blocks an SM of a 132-SM H100 where rows allow
_TARGET_BLOCKS = 4 * 132
_MAX_ROWS = 8               # canvas rows a K1 block, at most
_LANE_ELEMS = 16            # canvas elements a K1 lane loads a span

_ELEM_BYTES = (1, 2, 4)


def library() -> ctypes.CDLL:
    """Build (first call) and load the kernel library."""
    lib = _build.load_library(LIBRARY, [SOURCE])
    if not getattr(lib, "_typed", False):
        args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
        # K1 takes its launch plan (stitch_plan) after the shared arguments
        lib.tangram_stitch.argtypes = (args + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        lib.tangram_unstitch.argtypes = args + [ctypes.c_void_p]
        for fn in (lib.tangram_stitch, lib.tangram_unstitch):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def stitch_plan(b: int, m: int, n: int, c: int, elem_bytes: int):
    """K1's launch for B canvases of M x N pixels of C elements of
    ``elem_bytes``: ``(rows_per_block, pixels_per_group, store_bytes,
    smem_bytes)``, as the source lays a block out.

    The store is the widest of 16, 8, 4, 2 or 1 bytes that divides a canvas
    row's bytes, so stores never straddle a row and stay aligned; a group
    is the fewest whole pixels whose bytes are a multiple of the store (4
    pixels = 48 B at C=3 float32, 16 at C=3 uint8), so groups tile every
    row.  A block takes 8 canvas rows, halved while the grid would have
    fewer than ``_TARGET_BLOCKS`` blocks or the block more shared memory
    than the card gives.  Its shared memory: the int16 owner map (rows x N
    rounded up to 8), the live list (``MAX_RECORDS_PER_CANVAS`` int16) and
    its count (16 B), a uint32 slot offset a record, and a span buffer of
    ``32 * _LANE_ELEMS`` elements for each of the block's 8 warps.  Raises
    when even one row does not fit."""
    pixel = c * elem_bytes
    store = 16
    while (n * pixel) % store:
        store //= 2
    group = store // math.gcd(pixel, store)
    pitch = -(-n // 8) * 8

    def smem(rows):
        return (rows * pitch * 2 + MAX_RECORDS_PER_CANVAS * 6 + 16
                + 8 * 32 * _LANE_ELEMS * elem_bytes)

    rows = _MAX_ROWS
    while rows > 1 and (-(-m // rows) * b < _TARGET_BLOCKS
                        or smem(rows) > _SMEM_LIMIT):
        rows //= 2
    if smem(rows) > _SMEM_LIMIT:
        raise ValueError(f"stitch: a {n}-pixel canvas row needs "
                         f"{smem(rows)} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")
    return rows, group, store, smem(rows)


def _check(name: str, pixels: torch.Tensor, records: torch.Tensor):
    if pixels.device.type != "cuda" or records.device != pixels.device:
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{pixels.device} and {records.device}")
    if pixels.dim() != 4 or not pixels.is_contiguous():
        raise ValueError(f"{name}: pixels must be a contiguous 4-d tensor, "
                         f"got shape {tuple(pixels.shape)}")
    if pixels.element_size() not in _ELEM_BYTES or pixels.is_complex():
        raise ValueError(f"{name}: unsupported dtype {pixels.dtype}")
    if (records.dtype != torch.int32 or records.dim() != 3
            or records.shape[-1] != 6 or not records.is_contiguous()):
        raise ValueError(f"{name}: records must be contiguous (B, K, 6) "
                         f"int32, got {records.dtype} "
                         f"{tuple(records.shape)}")
    if records.shape[1] > MAX_RECORDS_PER_CANVAS:
        raise ValueError(f"{name}: {records.shape[1]} records per canvas "
                         f"exceeds {MAX_RECORDS_PER_CANVAS}")


def _launch(fn, src, records, out, hmax, wmax, c, b, k, m, n, plan=()):
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), records.data_ptr(), out.data_ptr(),
                hmax, wmax, c, b, k, m, n, src.element_size(), *plan,
                stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def stitch_cuda(patch_pixels: torch.Tensor, records: torch.Tensor,
                m: int, n: int) -> torch.Tensor:
    """K1: slots (P, Hmax, Wmax, C) + records (B, K, 6) -> (B, M, N, C).

    One launch from :func:`stitch_plan`: each block writes every byte of
    its canvas rows once, a pixel's owner being the last valid record (in
    k order) that covers it, as in the reference when placements overlap,
    and zero where none does.  The valid records must keep the kernels'
    contract, which the kernels do not re-check: inside the canvas, within
    the slot, slot index below P
    (:func:`repro_torch.kernels.stitch.ops.check_records` on the plan)."""
    _check("stitch", patch_pixels, records)
    p, hmax, wmax, c = patch_pixels.shape
    b, k, _ = records.shape
    if hmax > m or wmax > n:
        raise ValueError(f"stitch: slot {hmax}x{wmax} exceeds canvas {m}x{n}")
    if b > _MAX_GRID_Y:
        raise ValueError(f"stitch: {b} canvases exceed {_MAX_GRID_Y}")
    if patch_pixels.numel() >= 2**31 or n * c >= 2**31:
        raise ValueError(f"stitch: {patch_pixels.numel()} slot elements or "
                         f"a {n}-pixel row of {c} channels exceed int32 "
                         f"offsets")
    plan = stitch_plan(b, m, n, c, patch_pixels.element_size())
    if b == 0 or k == 0 or p == 0:
        # empty packing: a zero canvas batch, no degenerate launch
        return torch.zeros((b, m, n, c), dtype=patch_pixels.dtype,
                           device=patch_pixels.device)
    out = torch.empty((b, m, n, c), dtype=patch_pixels.dtype,
                      device=patch_pixels.device)   # every element written
    _launch(library().tangram_stitch, patch_pixels, records, out, hmax,
            wmax, c, b, k, m, n, plan)
    count_launch("stitch")
    return out


def unstitch_cuda(canvases: torch.Tensor, records: torch.Tensor,
                  num_patches: int, hmax: int, wmax: int) -> torch.Tensor:
    """K2: canvases (B, M, N, C) + records -> (num_patches, hmax, wmax, C).

    The output is allocated zeroed and the kernel copies each valid
    placement's (h, w) region into it, so slot padding and slots no valid
    record references are zero.  Records keep K1's contract."""
    _check("unstitch", canvases, records)
    b, m, n, c = canvases.shape
    k = records.shape[1]
    if records.shape[0] != b:
        raise ValueError(f"unstitch: {records.shape[0]} record rows for "
                         f"{b} canvases")
    if hmax > m or wmax > n:
        raise ValueError(f"unstitch: slot {hmax}x{wmax} exceeds canvas "
                         f"{m}x{n}")
    out = torch.zeros((num_patches, hmax, wmax, c), dtype=canvases.dtype,
                      device=canvases.device)
    if num_patches == 0 or b == 0 or k == 0:
        return out
    _launch(library().tangram_unstitch, canvases, records, out, hmax, wmax,
            c, b, k, m, n)
    count_launch("unstitch")
    return out
