"""Latency Estimator (Section III-C).

Port of ``repro/core/latency.py``.  A table maps a canvas batch size to a
profiled ``(mu, sigma)`` and serves the conservative slack
``T_slack = mu + k * sigma`` (k = 3 in the paper).
:class:`OnlineLatencyTable` refreshes a table from delivered completions
(EWMA, per-worker drift), :class:`LatencyBank` keeps one estimator per
model, and ``to_dict`` / :func:`latency_from_dict` log and rebuild them.
A table has two sources:

* :func:`measure` times a real callable (the paper's offline profiling,
  scaled down); on the card pass ``sync=torch.cuda.synchronize`` so the
  wait for the device lands inside the timed region;
* :class:`AnalyticalLatencyModel` is a roofline time over the H100
  data-sheet constants in :class:`~repro_torch.config.HardwareConfig`.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.config import HardwareConfig
from repro_torch.core.registry import lookup, unknown_name


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

    # JSON stringifies the int batch keys and turns the (mu, sigma) tuples
    # into lists, so these helpers, not ``dataclasses.asdict``, are the
    # logging surface
    def to_dict(self) -> dict:
        return {"kind": "profile",
                "slack_sigmas": self.slack_sigmas,
                "table": {str(k): [float(m), float(s)]
                          for k, (m, s) in sorted(self.table.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyTable":
        return cls({int(k): (float(m), float(s))
                    for k, (m, s) in d["table"].items()},
                   slack_sigmas=float(d.get("slack_sigmas", 3.0)))


class OnlineLatencyTable:
    """A latency estimator that refreshes itself from delivered completions.

    With no observations it is exactly the profiled ``seed`` table; then
    every observed ``(batch, elapsed)`` folds in:

    * batch sizes observed directly serve an EWMA mean and an
      EWMA-variance sigma (floored at the drift-scaled seed sigma);
    * other batch sizes serve the seed scaled by the EWMA of observed/seed
      ratios, clamped to ``ratio_bounds``.

    Per-worker drift ratios are tracked beside (``drift(worker=i)``); the
    served estimate aggregates every worker, since the invoker cannot know
    where its next batch lands.  Non-finite or non-positive observations
    are rejected (``n_rejected``), and valid ones are clamped into
    ``ratio_bounds`` times the seed before the update, so every served
    ``(mu, sigma)`` stays finite with ``mu > 0``.

    It duck-types :class:`LatencyTable` (``mu_sigma`` / ``t_slack`` /
    ``slack_sigmas``): hand the same instance to the invokers and to the
    worker pool that calls :meth:`observe`.
    """

    _TINY = 1e-12

    def __init__(self, seed: LatencyTable, alpha: float = 0.25,
                 ratio_bounds: Tuple[float, float] = (0.05, 50.0)):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        lo, hi = ratio_bounds
        if not 0.0 < lo <= hi:
            raise ValueError(f"bad ratio_bounds {ratio_bounds}")
        self.seed = seed
        self.alpha = alpha
        self.ratio_bounds = ratio_bounds
        self._mu: Dict[int, float] = {}
        self._var: Dict[int, float] = {}
        self._count: Dict[int, int] = {}
        self._ratio: Optional[float] = None
        self._worker_ratio: Dict[object, float] = {}
        self.n_observations = 0
        self.n_rejected = 0
        # the EWMA updates are read-modify-write: observers and readers on
        # other threads take this lock
        self._lock = threading.RLock()

    @property
    def slack_sigmas(self) -> float:
        return self.seed.slack_sigmas

    def _clamped(self, ratio: Optional[float]) -> float:
        if ratio is None:
            return 1.0
        lo, hi = self.ratio_bounds
        return min(max(ratio, lo), hi)

    def drift(self, worker: Optional[object] = None) -> float:
        """Clamped EWMA of observed/seed latency (1.0: the profile holds).
        ``worker=None``, or a worker with no observations, reads the
        aggregate."""
        with self._lock:
            if worker is not None and worker in self._worker_ratio:
                return self._clamped(self._worker_ratio[worker])
            return self._clamped(self._ratio)

    def observe(self, batch: int, elapsed: float,
                worker: Optional[object] = None,
                model: Optional[str] = None) -> bool:
        """Fold one delivered completion in; False (and no change) for a
        non-finite or non-positive ``elapsed`` or an empty batch.
        ``model`` is accepted and ignored, so this table and
        :class:`LatencyBank` are interchangeable behind the worker pool."""
        try:
            elapsed = float(elapsed)
        except (TypeError, ValueError):
            with self._lock:
                self.n_rejected += 1
            return False
        if batch < 1 or not math.isfinite(elapsed) or elapsed <= 0.0:
            with self._lock:
                self.n_rejected += 1
            return False
        with self._lock:
            self.n_observations += 1
            a = self.alpha
            lo, hi = self.ratio_bounds
            seed_mu = max(self.seed.mu_sigma(batch)[0], self._TINY)
            elapsed = min(max(elapsed, lo * seed_mu), hi * seed_mu)
            if batch not in self._mu:
                self._mu[batch] = elapsed
                self._var[batch] = 0.0
                self._count[batch] = 1
            else:
                delta = elapsed - self._mu[batch]
                self._mu[batch] += a * delta
                # EWMA variance (West): decay the old spread, add the new
                # deviation's share
                self._var[batch] = (1.0 - a) * (self._var[batch]
                                                + a * delta * delta)
                self._count[batch] += 1
            r = elapsed / seed_mu             # in [lo, hi] by construction
            self._ratio = r if self._ratio is None else (
                self._ratio + a * (r - self._ratio))
            if worker is not None:
                prev = self._worker_ratio.get(worker)
                self._worker_ratio[worker] = r if prev is None else (
                    prev + a * (r - prev))
        return True

    def mu_sigma(self, batch: int) -> Tuple[float, float]:
        with self._lock:
            if self.n_observations == 0:
                return self.seed.mu_sigma(batch)  # exactly the seed
            r = self._clamped(self._ratio)
            seed_mu, seed_sigma = self.seed.mu_sigma(batch)
            if batch in self._mu:
                mu = max(self._mu[batch], self._TINY)
                sigma = max(math.sqrt(max(self._var[batch], 0.0)),
                            seed_sigma * r, 0.0)
                return mu, sigma
            return max(seed_mu * r, self._TINY), max(seed_sigma * r, 0.0)

    def t_slack(self, batch: int) -> float:
        if batch <= 0:
            return 0.0
        mu, sigma = self.mu_sigma(batch)
        return mu + self.slack_sigmas * sigma

    def to_dict(self) -> dict:
        """The seed profile and the EWMA knobs; the learned state is not
        kept, so a loaded estimator starts at its seed."""
        return {"kind": "online",
                "seed": self.seed.to_dict(),
                "alpha": self.alpha,
                "ratio_bounds": list(self.ratio_bounds)}

    @classmethod
    def from_dict(cls, d: dict) -> "OnlineLatencyTable":
        return cls(LatencyTable.from_dict(d["seed"]),
                   alpha=float(d.get("alpha", 0.25)),
                   ratio_bounds=tuple(d.get("ratio_bounds", (0.05, 50.0))))


class LatencyBank:
    """Per-model latency estimates behind one estimator interface.

    ``tables`` maps a registry model name to its estimator (a
    :class:`LatencyTable`, or an :class:`OnlineLatencyTable` for the
    feedback loop).  Observations route to the invocation's model's table,
    so each model tracks its own device speed.  An untagged observation
    (``model=None``) goes to the ``default`` table, which is the sole
    entry when the bank holds one, else nowhere (``observe`` returns
    False).
    """

    def __init__(self, tables: Dict[str, object],
                 default: Optional[str] = None):
        if not tables:
            raise ValueError("LatencyBank needs at least one table")
        self.tables: Dict[str, object] = dict(tables)
        if default is not None and default not in self.tables:
            raise unknown_name("model", default, self.tables)
        if default is None and len(self.tables) == 1:
            default = next(iter(self.tables))
        self.default = default

    def table(self, model: Optional[str]):
        """The estimator for one model (``None``: the default table)."""
        if model is None:
            model = self.default
        return lookup("model", self.tables, model)

    def observe(self, batch: int, elapsed: float,
                worker: Optional[object] = None,
                model: Optional[str] = None) -> bool:
        name = model if model is not None else self.default
        tbl = self.tables.get(name)
        observe = getattr(tbl, "observe", None)
        if observe is None:
            return False
        return observe(batch, elapsed, worker=worker)

    def drift(self, worker: Optional[object] = None,
              model: Optional[str] = None) -> float:
        """One model's drift, or (``model=None``) the mean over the
        models that track one."""
        if model is not None:
            drift = getattr(self.table(model), "drift", None)
            return drift(worker=worker) if drift is not None else 1.0
        drifts = [t.drift(worker=worker) for t in self.tables.values()
                  if hasattr(t, "drift")]
        if not drifts:
            return 1.0
        return sum(drifts) / len(drifts)

    def to_dict(self) -> dict:
        return {"kind": "bank",
                "default": self.default,
                "tables": {name: t.to_dict()
                           for name, t in sorted(self.tables.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyBank":
        return cls({name: latency_from_dict(t)
                    for name, t in d["tables"].items()},
                   default=d.get("default"))


def latency_from_dict(d: dict):
    """Inverse of the ``to_dict`` family, keyed on the embedded ``kind``
    (``profile`` | ``online`` | ``bank``)."""
    loaders = {"profile": LatencyTable.from_dict,
               "online": OnlineLatencyTable.from_dict,
               "bank": LatencyBank.from_dict}
    return lookup("latency spec kind", loaders, d.get("kind", "profile"))(d)


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
