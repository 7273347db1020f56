"""Hand-written CUDA kernels for flash attention (K6) and flash decode (K7).

Port of ``repro/kernels/attention/flash.py`` (``flash_attention``,
``flash_decode``).  The kernels live in ``csrc/flash.cu`` (design, masking
semantics and bounds in its header); this module builds them on first use,
checks every argument, allocates the outputs and scratch, launches on
PyTorch's current stream, and counts launches under ``"flash_attention"``
and ``"flash_decode"`` in :data:`repro_torch.kernels.launches.LAUNCHES`.

A CUDA tensor always goes to the kernel; anything the kernel does not take
raises.  The plain PyTorch versions (``mha_reference`` /
``decode_reference``, from :mod:`.ref`) are re-exported here: they are what
a CPU tensor runs and what the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import (  # noqa: F401  (re-export)
    NEG_INF, decode_reference, mha_reference)
from repro_torch.kernels.launches import LAUNCHES

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash.cu"
LIBRARY = "tangram_flash"

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
#: q / k / v dtypes the kernels take -> the C interface's bf16 flag
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_TILE = 64              # positions per K7 / float32 K6 tile (kBKV)
#: the bf16 K6 kernel's tiles (kWgBQ, kWgBKV, kWgStages in the source):
#: query rows a block, positions a KV tile, K/V ring stages
WG_ROWS, WG_TILE, WG_STAGES = 128, 128, 2
_MAX_CHUNK_TILES = 8    # K7 chunks of at most 512 positions
_SMEM_LIMIT = 232448    # bytes of shared memory a Hopper block can have


def library() -> ctypes.CDLL:
    """Build (first call) and load the kernel library."""
    lib = _build.load_library(LIBRARY, [SOURCE])
    if not getattr(lib, "_typed", False):
        lib.tangram_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p])
        lib.tangram_flash_decode.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p])
        for fn in (lib.tangram_flash_attention, lib.tangram_flash_decode):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def wgmma_plan(b: int, sq: int, h: int, d: int):
    """Grid and dynamic shared-memory bytes of the bf16 K6 launch, as the
    source's ``WgLayout`` lays a block out: Q (``WG_ROWS`` x D bf16), the
    K and V rings, 1 + 2 per stage barriers and 1024 bytes of alignment
    slack.  Blocks run the last query tile first (the heaviest when
    causal): block x takes query rows from ``(grid[0] - 1 - x) * WG_ROWS``."""
    smem = (WG_ROWS * d * 2 + 2 * WG_STAGES * WG_TILE * d * 2
            + 8 * (1 + 2 * WG_STAGES) + 1024)
    return (-(-sq // WG_ROWS), h, b), smem


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on one CUDA device, got "
                         f"q on {q.device}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, expected "
                             f"{q.device}")
        if t.dtype not in _BF16_FLAG:
            raise ValueError(f"{name}: {what} has unsupported dtype "
                             f"{t.dtype}; the kernel takes "
                             f"{[str(d) for d in _BF16_FLAG]}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous 4-d "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{kvh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {b} or {h} heads exceed "
                         f"{_MAX_GRID_YZ}")


def _launch_failed(fn: str, rc: int) -> RuntimeError:
    return RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K6: q (B, Sq, H, D), k / v (B, Skv, Kv, D) -> context (B, Sq, H, D)
    in q's dtype; any S (the kernel masks its own ragged edge)."""
    name = "flash_attention"
    _check_qkv(name, q, k, v)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if (causal or segment_ids is not None) and sq != skv:
        raise ValueError(f"{name}: causal attention and segment ids take "
                         f"Sq == Skv (absolute positions from 0), got "
                         f"{sq} and {skv}")
    if segment_ids is not None:
        if (segment_ids.device != q.device
                or segment_ids.dtype != torch.int32
                or tuple(segment_ids.shape) != (b, sq)
                or not segment_ids.is_contiguous()):
            raise ValueError(f"{name}: segment_ids must be a contiguous "
                             f"(B, S) = {(b, sq)} int32 tensor on "
                             f"{q.device}, got {segment_ids.dtype} "
                             f"{tuple(segment_ids.shape)} on "
                             f"{segment_ids.device}")
    if q.dtype == torch.bfloat16:
        _, smem = wgmma_plan(b, sq, h, d)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"{name}: head dim {d} needs {smem} bytes of "
                             f"shared memory, more than {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    seg_ptr = segment_ids.data_ptr() if segment_ids is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = library().tangram_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr,
            out.data_ptr(), b, sq, skv, h, kvh, d, int(causal),
            1.0 / math.sqrt(d), _BF16_FLAG[q.dtype], stream)
    if rc != 0:
        raise _launch_failed("tangram_flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_chunk(n_valid: int, pairs: int, sms: int) -> int:
    """K7's chunk of positions: a multiple of the 64-position tile, from 64
    to 512, chosen so that ``pairs`` (batch x KV head) times the number of
    chunks covering ``n_valid`` positions gives about two blocks per SM."""
    tiles = -(-n_valid // _TILE)
    per_chunk = -(-tiles * pairs // (2 * sms))
    return _TILE * max(1, min(_MAX_CHUNK_TILES, per_chunk))


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """K7: q (B, 1, H, D), cache k / v (B, Smax, Kv, D), attend to
    positions 0..pos -> (B, 1, H, D) in q's dtype.  ``pos`` is a host int
    (the grid is sized to it, and no device value is read back)."""
    name = "flash_decode"
    _check_qkv(name, q, k, v)
    b, one, h, d = q.shape
    smax, kvh = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"{name}: q must be (B, 1, H, D), got "
                         f"{tuple(q.shape)}")
    if isinstance(pos, torch.Tensor) or not 0 <= int(pos) < smax:
        raise ValueError(f"{name}: pos must be a Python int in [0, {smax}), "
                         f"got {pos!r}")
    pos = int(pos)
    g = h // kvh
    smem = 4 * (_TILE * (d * q.element_size() // 4 + 1)
                + _TILE * d * q.element_size() // 4
                + g * (2 * d + _TILE + 3))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: a group of {g} query heads needs {smem} "
                         f"bytes of shared memory, more than {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk = decode_chunk(pos + 1, b * kvh, _sm_count(q.device))
    n_chunks = pos // chunk + 1
    part_ml = torch.empty((b, h, n_chunks, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, h, n_chunks, d), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = library().tangram_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), b, smax, h, kvh, d, pos,
            chunk, 1.0 / math.sqrt(d), _BF16_FLAG[q.dtype], stream)
    if rc != 0:
        raise _launch_failed("tangram_flash_decode", rc)
    LAUNCHES["flash_decode"] += 1
    return out
