"""Tangram's stitching idea applied to LM serving: 1-D sequence packing.

Port of ``repro/core/sequence_packing.py``.  A patch is a variable-length
token span; a canvas is one row of a fixed (rows x seq_len) prefill buffer.
The placement rule is the 1-D projection of the paper's best-short-side
fit: choose the row whose remaining space leaves the smallest residual
(best fit), open a new row when none fits.  The SLO-aware invoker
semantics are reused verbatim through the port's ``SLOAwareInvoker``.

:func:`segment_ids` (the port's addition) turns packed rows into the
(rows, seq_len) int32 segment ids that K6's segment masking takes, the
spans of :func:`attention_mask_blocks` as one id each.  Nothing on the
model path calls this module, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    n_tokens: int
    t_gen: float
    slo: float
    request_id: int = 0

    @property
    def deadline(self) -> float:
        return self.t_gen + self.slo


@dataclasses.dataclass
class Row:
    seq_len: int
    spans: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)                 # (request_idx, start, end)

    @property
    def used(self) -> int:
        return sum(e - s for _, s, e in self.spans)

    @property
    def free(self) -> int:
        return self.seq_len - self.used

    @property
    def efficiency(self) -> float:
        return self.used / self.seq_len


def pack(requests: Sequence[Request], seq_len: int) -> List[Row]:
    """Best-fit packing of requests (queue order) into fixed-length rows."""
    rows: List[Row] = []
    for i, r in enumerate(requests):
        if r.n_tokens > seq_len:
            raise ValueError(f"request {i} longer than row ({r.n_tokens})")
        best, best_free = None, None
        for row in rows:
            if row.free >= r.n_tokens:
                if best_free is None or row.free < best_free:
                    best, best_free = row, row.free
        if best is None:
            best = Row(seq_len)
            rows.append(best)
        start = best.used
        best.spans.append((i, start, start + r.n_tokens))
    return rows


def packing_efficiency(rows: Sequence[Row]) -> float:
    if not rows:
        return 0.0
    return sum(r.used for r in rows) / sum(r.seq_len for r in rows)


def attention_mask_blocks(rows: List[Row]) -> List[List[Tuple[int, int]]]:
    """Per-row block-diagonal attention spans (packed sequences must not
    attend across request boundaries); consumed by the flash kernel's
    segment masking."""
    return [[(s, e) for _, s, e in row.spans] for row in rows]


def segment_ids(rows: List[Row]) -> np.ndarray:
    """(len(rows), seq_len) int32: span j of a row is segment j, and the
    unused tail of a row is a segment of its own (it attends only to
    itself, so its garbage never reaches a request)."""
    if not rows:
        return np.zeros((0, 0), np.int32)
    out = np.empty((len(rows), rows[0].seq_len), np.int32)
    for i, spans in enumerate(attention_mask_blocks(rows)):
        out[i] = len(spans)
        for j, (s, e) in enumerate(spans):
            out[i, s:e] = j
    return out


class SequencePacker:
    """Adapter exposing Request packing through the Tangram invoker.

    Requests masquerade as 1-px-tall patches (w = n_tokens, h = 1) on an
    (1 x seq_len) canvas, so ``SLOAwareInvoker`` + ``stitch`` drive the
    exact same control path that serves vision canvases.
    """

    def __init__(self, seq_len: int, latency, max_rows: int = 64):
        from repro_torch.core.invoker import SLOAwareInvoker
        self.seq_len = seq_len
        self.invoker = SLOAwareInvoker(1, seq_len, latency,
                                       max_canvases=max_rows)

    def on_request(self, t_now: float, r: Request):
        from repro_torch.core.partitioning import Patch
        p = Patch(0, 0, r.n_tokens, 1, frame_id=r.request_id,
                  t_gen=r.t_gen, slo=r.slo)
        return self.invoker.on_patch(t_now, p)

    def poll(self, t_now: float):
        return self.invoker.poll(t_now)

    def next_timer(self) -> float:
        return self.invoker.next_timer()
