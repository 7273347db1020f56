"""Live camera sources: the edge half of the paper as a Source.

Port of ``repro/sources/camera.py``.  Each camera runs the per-frame edge
pipeline - GMM background subtraction -> RoI extraction -> adaptive frame
partitioning (Alg. 1) - and ships the patches over its own FIFO uplink.
GMM and RoI extraction run on the source's ``device`` (default ``cuda``):
on the card the GMM update is the hand-written kernel K5
(:func:`repro_torch.kernels.gmm.ops.gmm_update`; ``gmm_impl="torch"`` asks
for its plain version), RoI extraction is plain PyTorch.  Frames are
rendered and partitioned on the host.

Frame timing comes from a seeded :class:`RateProfile`.  Between frames the
source reads the engine's backlog against its ingestion window and applies
an overload policy: ``"drop"`` the frame (the background model still
updates), ``"degrade"`` RoI quality (dropping at twice the window), or
``"none"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gmm, partitioning
from repro_torch.core.rois import RoIConfig, extract_rois
from repro_torch.data.synthetic import Scene, preset
from repro_torch.data.video import Arrival, Uplink
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.sources.base import SourceStats


@dataclasses.dataclass(frozen=True)
class RateProfile:
    """Seeded frame clock: ``fps * (1 + diurnal_amplitude * sin(2 pi t /
    diurnal_period_s))``, times ``burst_factor`` on frames where a seeded
    coin lands under ``burst_prob``.  Defaults give a constant 1/fps."""

    fps: float = 10.0
    diurnal_amplitude: float = 0.0   # in [0, 1)
    diurnal_period_s: float = 60.0
    burst_prob: float = 0.0
    burst_factor: float = 3.0
    seed: int = 0

    def __post_init__(self):
        if self.fps <= 0:
            raise ValueError(f"fps must be positive, got {self.fps}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if self.burst_factor <= 0:
            raise ValueError(f"burst_factor must be positive, got "
                             f"{self.burst_factor}")

    def intervals(self) -> Iterator[float]:
        """Yield successive frame intervals (seconds)."""
        rng = np.random.default_rng(self.seed)
        t = 0.0
        while True:
            rate = self.fps * (1.0 + self.diurnal_amplitude
                               * math.sin(2.0 * math.pi * t
                                          / self.diurnal_period_s))
            if self.burst_prob > 0 and rng.random() < self.burst_prob:
                rate *= self.burst_factor
            dt = 1.0 / rate
            t += dt
            yield dt


class EdgePipeline:
    """Per-camera frame -> patches: GMM -> RoIs -> Alg. 1 -> canvas clamp.
    Holds the GMM background state (on ``device``, ``None`` -> ``cuda``)
    across frames.  ``gmm_impl`` picks the GMM update as
    :func:`~repro_torch.kernels.gmm.ops.gmm_update` does (``None``: K5 on
    the card, the plain version on the CPU)."""

    def __init__(self, height: int, width: int, canvas: int,
                 slo: float = 1.0, roi_cfg: RoIConfig = RoIConfig(),
                 zones: Tuple[int, int] = (4, 4), warmup_s: float = 1.0,
                 device: DeviceLike = None, gmm_impl: Optional[str] = None):
        device = resolve_device(device)
        self.height, self.width = height, width
        self.canvas = canvas
        self.slo = slo
        self.roi_cfg = roi_cfg
        self.roi_degraded = roi_cfg.degraded()
        self.zones = zones
        self.warmup_s = warmup_s
        self.device = device
        self.state = gmm.init_state(height, width, device=device)
        # checked now: an unknown name, or "cuda" on the CPU, raises here
        self.gmm_impl = gmm_ops.resolve_impl(gmm_impl, self.state["w"])

    def _update(self, frame: np.ndarray) -> torch.Tensor:
        pixels = torch.from_numpy(np.ascontiguousarray(frame, np.float32))
        self.state, fg = gmm_ops.gmm_update(
            self.state, pixels.to(self.device), impl=self.gmm_impl)
        return fg

    def observe(self, frame: np.ndarray) -> None:
        """Update the background model only (the drop path)."""
        self._update(frame)

    def process(self, t: float, frame: np.ndarray, frame_id: int,
                camera_id: int, degrade: bool = False):
        """Full pipeline for one frame; [] during GMM warm-up."""
        fg = self._update(frame)
        if t < self.warmup_s:
            return []
        cfg = self.roi_degraded if degrade else self.roi_cfg
        boxes, valid = extract_rois(fg, cfg)
        boxes_np = boxes[valid].cpu().numpy()
        patches = partitioning.partition_host(
            boxes_np, self.width, self.height, *self.zones,
            frame_id=frame_id, camera_id=camera_id, t_gen=t, slo=self.slo)
        # enclosing rects can exceed zones; clamp to the canvas tile
        c = self.canvas
        return [partitioning.Patch(
            p.x0, p.y0, min(p.x1, p.x0 + c), min(p.y1, p.y0 + c),
            p.frame_id, p.camera_id, p.t_gen, p.slo) for p in patches]


class LiveSource:
    """Shared frame loop for live sources.

    Subclasses provide ``_frame(idx) -> (frame_id, gray)`` and optionally
    ``_rgb()``.  ``frame_sink`` (if set) receives ``(frame_id, rgb,
    n_patches)`` for every transmitted frame - the hook device executors
    use to register frames in their refcounted store.  Single-use.
    """

    kind = "live"

    def __init__(self, height: int, width: int, n_frames: int,
                 canvas: int = 256, slo: float = 1.0,
                 bandwidth_bps: float = 40e6, camera_id: int = 0,
                 rate: Optional[RateProfile] = None,
                 overload: str = "drop", warmup_s: float = 1.0,
                 roi_cfg: RoIConfig = RoIConfig(),
                 frame_sink: Optional[Callable] = None,
                 device: DeviceLike = None, gmm_impl: Optional[str] = None):
        if overload not in ("drop", "degrade", "none"):
            raise ValueError(f"unknown overload policy {overload!r}; "
                             f"choose from ['degrade', 'drop', 'none']")
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        self.n_frames = n_frames
        self.camera_id = camera_id
        self.rate = rate if rate is not None else RateProfile()
        self.overload = overload
        self.frame_sink = frame_sink
        self.pipeline = EdgePipeline(height, width, canvas, slo=slo,
                                     roi_cfg=roi_cfg, warmup_s=warmup_s,
                                     device=device, gmm_impl=gmm_impl)
        self.uplink = Uplink(bandwidth_bps)
        self._stats = SourceStats(kind=self.kind)

    def _frame(self, idx: int) -> Tuple[int, np.ndarray]:
        """Produce frame ``idx``: (frame_id, grayscale (H, W) float32)."""
        raise NotImplementedError

    def _rgb(self, frame: np.ndarray) -> np.ndarray:
        return np.stack([frame, frame, frame], axis=-1)

    def _policy(self, engine) -> str:
        """One of "send" | "degrade" | "drop" for the next frame."""
        window = getattr(engine, "ingestion_window", None) \
            if engine is not None else None
        if window is None or self.overload == "none":
            return "send"
        backlog = engine.backlog()
        if backlog < window:
            return "send"
        if self.overload == "drop" or backlog >= 2 * window:
            return "drop"
        return "degrade"

    def events(self, engine) -> Iterator[Arrival]:
        t = 0.0
        intervals = self.rate.intervals()
        for idx in range(self.n_frames):
            t += next(intervals)
            frame_id, frame = self._frame(idx)
            self._stats.frames_total += 1
            action = self._policy(engine)
            if action == "drop":
                self.pipeline.observe(frame)   # background stays fresh
                self._stats.frames_dropped += 1
                continue
            if action == "degrade":
                self._stats.frames_degraded += 1
            patches = self.pipeline.process(t, frame, frame_id,
                                            self.camera_id,
                                            degrade=action == "degrade")
            if self.frame_sink is not None:
                self.frame_sink(frame_id, self._rgb(frame), len(patches))
            for p in patches:
                yield self.uplink.send(p)

    def stats(self) -> SourceStats:
        s = dataclasses.replace(self._stats)
        s.arrivals = s.patches_emitted = self.uplink.n_sent
        s.bytes_sent = self.uplink.bytes_sent
        s.transmission_seconds = self.uplink.transmission_seconds
        return s


class SyntheticCameraSource(LiveSource):
    """A PANDA-like synthetic camera running the live edge pipeline.
    Frame ids embed the camera id (``camera_id << 20 | frame index``)."""

    kind = "synthetic"

    def __init__(self, scene: int = 0, n_frames: int = 40,
                 canvas: int = 256, width: Optional[int] = None,
                 height: Optional[int] = None, **kwargs):
        width = width if width is not None else 2 * canvas
        height = height if height is not None else canvas
        self.scene = Scene(preset(scene, width=width, height=height))
        super().__init__(height, width, n_frames, canvas=canvas, **kwargs)

    def _frame(self, idx: int) -> Tuple[int, np.ndarray]:
        self.scene.step()
        return (self.camera_id << 20) | self.scene.t, self.scene.render()

    def _rgb(self, frame: np.ndarray) -> np.ndarray:
        return self.scene.render_rgb()


def synthetic_source(n_cameras: int = 1, scene: int = 0, **cfg):
    """Registry factory for ``make_source("synthetic", ...)``: one camera,
    or ``n_cameras`` with distinct scene presets/ids merged into one
    stream."""
    from repro_torch.sources.base import MergedSource
    if n_cameras < 1:
        raise ValueError(f"n_cameras must be >= 1, got {n_cameras}")
    if n_cameras == 1:
        return SyntheticCameraSource(scene=scene, **cfg)
    return MergedSource([
        SyntheticCameraSource(scene=scene + i, camera_id=i, **cfg)
        for i in range(n_cameras)])
