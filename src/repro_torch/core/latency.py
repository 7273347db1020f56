"""Latency Estimator (Section III-C).

Port of ``LatencyTable``, ``measure``, ``AnalyticalLatencyModel`` and
``detector_latency_model`` from ``repro/core/latency.py``.  A table maps a
canvas batch size to a profiled ``(mu, sigma)`` and serves the conservative
slack ``T_slack = mu + k * sigma`` (k = 3 in the paper).  Two sources:

* :func:`measure` times a real callable (the paper's offline profiling,
  scaled down); on the card pass ``sync=torch.cuda.synchronize`` so the
  wait for the device lands inside the timed region;
* :class:`AnalyticalLatencyModel` is a roofline time over the H100
  data-sheet constants in :class:`~repro_torch.config.HardwareConfig`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.config import HardwareConfig


@dataclasses.dataclass
class LatencyTable:
    """batch_size -> (mu, sigma) with linear inter/extrapolation."""

    table: Dict[int, Tuple[float, float]]
    slack_sigmas: float = 3.0
    #: interpolation memo (``mu_sigma`` sits on the per-arrival firing
    #: path); the size guard drops it if profile points are added later
    _miss_cache: Dict[int, Tuple[float, float]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _cache_size: int = dataclasses.field(default=-1, init=False,
                                         repr=False, compare=False)

    def mu_sigma(self, batch: int) -> Tuple[float, float]:
        hit = self.table.get(batch)
        if hit is not None:
            return hit
        if self._cache_size == len(self.table):
            memo = self._miss_cache.get(batch)
            if memo is not None:
                return memo
        else:
            self._miss_cache.clear()
            self._cache_size = len(self.table)
        out = self._interpolate(batch)
        self._miss_cache[batch] = out
        return out

    def _interpolate(self, batch: int) -> Tuple[float, float]:
        keys = sorted(self.table)
        if not keys:
            raise ValueError("empty latency table")
        if batch <= keys[0]:
            # clamp below the smallest profiled point: the fixed
            # per-invocation overhead dominates there
            return self.table[keys[0]]
        if batch >= keys[-1]:
            # extrapolate from the last two points (throughput regime)
            if len(keys) == 1:
                k = keys[0]
                mu, sg = self.table[k]
                return mu * batch / k, sg * batch / k
            k0, k1 = keys[-2], keys[-1]
            (m0, s0), (m1, s1) = self.table[k0], self.table[k1]
            slope = (m1 - m0) / (k1 - k0)
            return m1 + slope * (batch - k1), max(s0, s1)
        lo = max(k for k in keys if k <= batch)
        hi = min(k for k in keys if k >= batch)
        (m0, s0), (m1, s1) = self.table[lo], self.table[hi]
        f = (batch - lo) / (hi - lo)
        return m0 + f * (m1 - m0), s0 + f * (s1 - s0)

    def t_slack(self, batch: int) -> float:
        """Conservative inference-time estimate for a batch of canvases."""
        if batch <= 0:
            return 0.0
        mu, sigma = self.mu_sigma(batch)
        return mu + self.slack_sigmas * sigma


@dataclasses.dataclass(frozen=True)
class AnalyticalLatencyModel:
    """Roofline latency for a canvas batch on ``cards`` H100s."""

    flops_per_canvas: float           # fwd FLOPs for one M x N canvas
    bytes_per_canvas: float           # HBM traffic for one canvas
    weight_bytes: float               # model weights read once per batch
    cards: int = 1
    hw: HardwareConfig = HardwareConfig()
    overhead_s: float = 0.004         # dispatch/launch overhead
    jitter_frac: float = 0.05         # sigma = jitter_frac * mu
    mma_eff: float = 0.55             # achievable fraction of peak

    def mu_sigma(self, batch: int) -> Tuple[float, float]:
        fl = self.flops_per_canvas * batch / (
            self.cards * self.hw.peak_flops * self.mma_eff)
        by = (self.bytes_per_canvas * batch + self.weight_bytes) / (
            self.cards * self.hw.hbm_bw)
        mu = max(fl, by) + self.overhead_s
        return mu, self.jitter_frac * mu

    def build_table(self, max_batch: int = 16,
                    slack_sigmas: float = 3.0) -> LatencyTable:
        return LatencyTable(
            {b: self.mu_sigma(b) for b in range(1, max_batch + 1)},
            slack_sigmas=slack_sigmas)


def measure(fn: Callable[[int], object], batch_sizes, iters: int = 30,
            warmup: int = 3, slack_sigmas: float = 3.0,
            sync: Optional[Callable[[], None]] = None) -> LatencyTable:
    """Offline profiling of a real callable (paper: 1000 iterations).

    ``fn(batch)`` may return before the device finishes (CUDA kernels are
    queued); ``sync()`` (e.g. ``torch.cuda.synchronize``) is called inside
    the timed region so the table holds compute time, not enqueue time.
    """
    table = {}
    for b in batch_sizes:
        for _ in range(warmup):
            fn(b)
            if sync is not None:
                sync()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(b)
            if sync is not None:
                sync()
            ts.append(time.perf_counter() - t0)
        table[b] = (float(np.mean(ts)), float(np.std(ts)))
    return LatencyTable(table, slack_sigmas=slack_sigmas)


def detector_flops(n_tokens: int, patch: int, n_layers: int, d_model: int,
                   d_ff: int) -> float:
    """Forward FLOPs of the ViT detector over ``n_tokens`` patch tokens."""
    s = n_tokens
    attn = 4 * d_model * d_model + 2 * s * d_model  # per token: proj + scores
    mlp = 2 * d_model * d_ff * 2
    per_token = 2 * (attn + mlp)
    embed = 2 * 3 * patch * patch * d_model
    return s * (n_layers * per_token + embed)


def detector_latency_model(res_h: int, res_w: int, *, patch: int = 32,
                           n_layers: int = 12, d_model: int = 768,
                           d_ff: int = 3072, cards: int = 1,
                           hw: Optional[HardwareConfig] = None,
                           overhead_s: float = 0.004,
                           jitter_frac: float = 0.05
                           ) -> AnalyticalLatencyModel:
    """Analytical model for the ViT detector on inputs of res_h x res_w."""
    tokens = (res_h // patch) * (res_w // patch)
    flops = detector_flops(tokens, patch, n_layers, d_model, d_ff)
    act_bytes = res_h * res_w * 3 * 4 + 8 * n_layers * tokens * d_model * 2
    d = d_model
    weight_bytes = n_layers * (4 * d * d + 2 * d * d_ff) * 2
    return AnalyticalLatencyModel(
        flops_per_canvas=flops, bytes_per_canvas=act_bytes,
        weight_bytes=weight_bytes, cards=cards,
        hw=hw or HardwareConfig(), overhead_s=overhead_s,
        jitter_frac=jitter_frac)
