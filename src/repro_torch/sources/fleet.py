"""Synthetic camera-fleet source: thousands of cameras, no pixels.

Port of ``repro/sources/fleet.py``.  A
:class:`~repro_torch.sources.camera.SyntheticCameraSource` runs the edge
pipeline on every frame, which cannot drive thousands of cameras.
:class:`FleetCameraSource` keeps what matters at fleet scale, each
camera's seeded :class:`~repro_torch.sources.camera.RateProfile` frame
clock (lognormal base rates, diurnal cycle, bursts), and emits RoI patches
from a deterministic per-camera geometry cycle.  The per-camera streams
merge under the stable ``(t_arrive, camera, seq)`` key, so the trace is
one sorted, reproducible stream, equal record for record to the JAX
source's for the same seed.  :meth:`~FleetCameraSource.camera_rates` and
:meth:`~FleetCameraSource.class_rates` are the
:class:`~repro_torch.core.fleet.FleetPlanner`'s inputs.

Registered as source name ``"fleet"``.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.partitioning import Patch
from repro_torch.data.video import Arrival, patch_bytes
from repro_torch.sources.base import SourceStats
from repro_torch.sources.camera import RateProfile

__all__ = ["FleetCameraSource", "fleet_source"]

#: RoI sizes cycled per (camera, frame, patch) — small/medium/large mix
_PATCH_SIZES: Tuple[Tuple[int, int], ...] = ((32, 32), (48, 48),
                                             (64, 64), (96, 96))
#: patches per frame cycles 1..3 (mean 2.0) — used by camera_rates()
_PATCHES_PER_FRAME = (1, 2, 3)
_MEAN_PATCHES = sum(_PATCHES_PER_FRAME) / len(_PATCHES_PER_FRAME)


class FleetCameraSource:
    """``n_cameras`` synthetic cameras with heterogeneous rate profiles.

    Camera ``c``'s frame rate is ``base_fps`` scaled by a seeded
    lognormal weight (``rate_sigma`` controls the spread — 0 gives a
    homogeneous fleet, ~1 a heavy-tailed one where a few hot cameras
    carry much of the load, the regime where planned shard layouts beat
    naive equal splits), with the shared diurnal amplitude/period and
    burst parameters riding on top (phase-shifted per camera via the
    profile seed).  Each frame emits 1-3 patches (deterministic cycle)
    whose geometry cycles through ``_PATCH_SIZES``; the camera's SLO is
    ``slos[c % len(slos)]``.

    ``duration_s`` bounds every camera's frame clock.  Backpressure is
    ignored (this is a trace generator, not a live loop) — pair with
    :class:`~repro_torch.sources.camera.LiveSource` semantics when drop /
    degrade behaviour matters.
    """

    def __init__(self, n_cameras: int = 1000, duration_s: float = 30.0,
                 base_fps: float = 1.0, rate_sigma: float = 1.0,
                 diurnal_amplitude: float = 0.3,
                 diurnal_period_s: float = 60.0,
                 burst_prob: float = 0.05, burst_factor: float = 3.0,
                 slos: Sequence[float] = (0.5, 2.0), seed: int = 0,
                 sorted_by_rate: bool = False):
        if n_cameras < 1:
            raise ValueError(f"n_cameras must be >= 1, got {n_cameras}")
        if duration_s <= 0:
            raise ValueError(f"duration_s must be positive, "
                             f"got {duration_s}")
        if not slos:
            raise ValueError("slos must not be empty")
        self.n_cameras = n_cameras
        self.duration_s = duration_s
        self.base_fps = base_fps
        self.diurnal_amplitude = diurnal_amplitude
        self.diurnal_period_s = diurnal_period_s
        self.burst_prob = burst_prob
        self.burst_factor = burst_factor
        self.slos = tuple(slos)
        self.seed = seed
        rng = np.random.default_rng(seed)
        weights = (np.exp(rng.normal(0.0, rate_sigma, size=n_cameras))
                   if rate_sigma > 0 else np.ones(n_cameras))
        if sorted_by_rate:
            # id-correlated load: cameras numbered by site, busiest sites
            # first — the regime where a contiguous equal split melts its
            # first shards and a rate-aware planner earns its keep
            weights = np.sort(weights)[::-1]
        self.sorted_by_rate = sorted_by_rate
        self.fps = np.clip(base_fps * weights, 0.05 * base_fps,
                           20.0 * base_fps)
        self._stats = SourceStats(kind=f"fleet[{n_cameras}]")

    # ------------------------------------------------------ planner feed ----

    def slo_of(self, camera_id: int) -> float:
        return self.slos[camera_id % len(self.slos)]

    def camera_rates(self) -> Dict[int, float]:
        """Expected patch arrivals/sec per camera (fps x mean patches
        per frame) — the :class:`~repro_torch.core.fleet.FleetPlanner` input."""
        return {c: float(self.fps[c]) * _MEAN_PATCHES
                for c in range(self.n_cameras)}

    def class_rates(self) -> Dict[float, float]:
        """Expected patch arrivals/sec per SLO class (reservations)."""
        rates: Dict[float, float] = {}
        for c in range(self.n_cameras):
            slo = self.slo_of(c)
            rates[slo] = rates.get(slo, 0.0) + float(self.fps[c]) \
                * _MEAN_PATCHES
        return rates

    def total_rate(self) -> float:
        return float(self.fps.sum()) * _MEAN_PATCHES

    # ---------------------------------------------------------- streaming ----

    def _camera_events(self, cam: int) -> Iterator[Arrival]:
        profile = RateProfile(
            fps=float(self.fps[cam]),
            diurnal_amplitude=self.diurnal_amplitude,
            diurnal_period_s=self.diurnal_period_s,
            burst_prob=self.burst_prob, burst_factor=self.burst_factor,
            seed=self.seed * 1000003 + cam)
        slo = self.slo_of(cam)
        n_sizes = len(_PATCH_SIZES)
        n_counts = len(_PATCHES_PER_FRAME)
        t = 0.0
        frame = 0
        for dt in profile.intervals():
            t += dt
            if t >= self.duration_s:
                return
            count = _PATCHES_PER_FRAME[(cam + frame) % n_counts]
            for i in range(count):
                w, h = _PATCH_SIZES[(cam + frame + i) % n_sizes]
                x0 = 16 * ((cam + 3 * i) % 8)
                y0 = 16 * ((frame + 5 * i) % 8)
                patch = Patch(x0, y0, x0 + w, y0 + h,
                              frame_id=(cam << 20) | frame,
                              camera_id=cam, t_gen=t, slo=slo)
                yield Arrival(t, patch, patch_bytes(patch))
            frame += 1

    def events(self, engine=None) -> Iterator[Arrival]:
        """Globally sorted fleet stream under the stable ``(t_arrive,
        camera, seq)`` merge key; records stats as it yields."""
        def keyed(cam: int):
            for seq, a in enumerate(self._camera_events(cam)):
                yield (a.t_arrive, a.patch.camera_id, seq), a

        streams = [keyed(c) for c in range(self.n_cameras)]
        for _key, a in heapq.merge(*streams, key=lambda ka: ka[0]):
            self._stats.arrivals += 1
            self._stats.patches_emitted += 1
            self._stats.bytes_sent += a.n_bytes
            yield a

    def arrivals(self) -> List[Arrival]:
        """The whole fleet trace, materialized (benchmark input — both
        the single-engine baseline and every shard-count arm replay the
        identical list)."""
        return list(self.events())

    def stats(self) -> SourceStats:
        return self._stats


def fleet_source(**cfg) -> FleetCameraSource:
    """Factory behind source name ``"fleet"``."""
    return FleetCameraSource(**cfg)
