"""Hand-written CUDA kernels for flash attention (K6) and flash decode (K7).

Port of ``repro/kernels/attention/flash.py`` (``flash_attention``,
``flash_decode``).  The kernels live in ``csrc/flash.cu`` (design, masking
semantics and bounds in its header); this module builds them on first use,
checks every argument, allocates the outputs, launches on PyTorch's
current stream, and counts launches under ``"flash_attention"`` and
``"flash_decode"`` in :data:`repro_torch.kernels.launches.LAUNCHES`.

K7 is one launch a call and needs no scratch: each block streams its
warps' 16-position K/V tiles through per-warp ``cp.async`` rings, runs
scores and P.V on the tensor cores (``mma.sync``), and the chunks of one
KV head, a thread-block cluster, merge their (m, l, acc) states through
distributed shared memory.  :func:`decode_plan` is its launch plan, kept
in step with the source's ``DecLayout``; the SM count is asked once per
device and the dynamic shared-memory attribute set once per kernel
instance, so a call's host work is the checks, one ``torch.empty`` and
the ctypes launch.

A CUDA tensor always goes to the kernel; anything the kernel does not take
raises.  The plain PyTorch versions (``mha_reference`` /
``decode_reference``, from :mod:`.ref`) are re-exported here: they are what
a CPU tensor runs and what the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import (  # noqa: F401  (re-export)
    NEG_INF, decode_reference, mha_reference)
from repro_torch.kernels.launches import count_launch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash.cu"
LIBRARY = "tangram_flash"

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
#: q / k / v dtypes the kernels take -> the C interface's bf16 flag
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
#: the bf16 K6 kernel's tiles (kWgBQ, kWgBKV, kWgStages in the source):
#: query rows a block, positions a KV tile, K/V ring stages
WG_ROWS, WG_TILE, WG_STAGES = 128, 128, 2
#: K7's block (kDecWarps, kDecTile, kDecStages, kDecHeads in the source):
#: warps a block, positions a warp's ring stage, stages a warp's ring,
#: query heads a block; a block's pass over the chunk takes
#: DEC_WARPS * DEC_TILE positions, and chunks are multiples of it
DEC_WARPS, DEC_TILE, DEC_STAGES, DEC_HEADS = 4, 16, 3, 16
DEC_MAX_CLUSTER = 8     # chunks a (batch, KV head): one portable cluster
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
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float,
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
    count_launch("flash_attention")
    return out


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a card, asked once per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


class DecodePlan(NamedTuple):
    grid: Tuple[int, int, int]      # (chunks, KV heads x head groups, B)
    cluster: Tuple[int, int, int]   # (chunks, 1, 1): a cluster per group
    chunk: int                      # positions a block, a multiple of 64
    stages: int                     # ring stages a warp
    smem: int                       # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=4096)
def decode_plan(b: int, smax: int, h: int, kvh: int, d: int, pos: int,
                dtype: torch.dtype, sms: int) -> DecodePlan:
    """K7's launch, as the source's ``DecLayout`` lays a block out.

    A block is ``DEC_WARPS`` warps; each warp streams its own 16-position
    tiles of K and V through a ring of ``DEC_STAGES`` stages (rows of D
    elements), and the block keeps one merged (m, l, acc) state of
    ``DEC_HEADS`` heads x D float32 (plus q and a score tile a warp for
    float32).  Blocks take up to 16 query heads of one KV head (G > 16
    takes ``ceil(G / 16)`` groups).  The positions 0..pos are cut into
    chunks of a multiple of 64, as many a (batch, KV head, group) as give
    about one block an SM on ``sms`` SMs, at most ``DEC_MAX_CLUSTER`` (one
    cluster); a bf16 block's shared memory is under half an SM's, so two
    may share an SM and every cluster of 8 finds room at once.  One block
    an SM streamed the 8 x 32768 slice 6% faster than two on the H100
    (``tools/time_decode.py``).  ``smax`` bounds nothing but pos."""
    if not 0 <= pos < smax:
        raise ValueError(f"pos {pos} outside [0, {smax})")
    elem = 2 if dtype == torch.bfloat16 else 4
    ring = DEC_WARPS * DEC_STAGES * 2 * DEC_TILE * d * elem
    state = (DEC_HEADS * d + 2 * DEC_HEADS) * 4
    smem = ring + state
    if dtype != torch.bfloat16:
        smem += DEC_HEADS * d * 4 + DEC_WARPS * DEC_HEADS * DEC_TILE * 4
    groups = -(-(h // kvh) // DEC_HEADS)
    per_pass = DEC_WARPS * DEC_TILE
    passes = -(-(pos + 1) // per_pass)
    n_chunks = max(1, min(DEC_MAX_CLUSTER, sms // (b * kvh * groups),
                          passes))
    chunk = -(-passes // n_chunks) * per_pass
    n_chunks = pos // chunk + 1
    return DecodePlan((n_chunks, kvh * groups, b), (n_chunks, 1, 1), chunk,
                      DEC_STAGES, smem)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """K7: q (B, 1, H, D), cache k / v (B, Smax, Kv, D), attend to
    positions 0..pos -> (B, 1, H, D) in q's dtype, in one launch.  ``pos``
    is a host int (the grid is sized to it, and no device value is read
    back)."""
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = decode_plan(b, smax, h, kvh, d, pos, q.dtype,
                       _sm_count(q.device))
    if plan.grid[1] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {kvh} KV heads x {plan.grid[1] // kvh} "
                         f"head groups exceed {_MAX_GRID_YZ}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = library().tangram_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            smax, h, kvh, d, pos, plan.chunk, 1.0 / math.sqrt(d),
            _BF16_FLAG[q.dtype], stream)
    if rc != 0:
        raise _launch_failed("tangram_flash_decode", rc)
    count_launch("flash_decode")
    return out
