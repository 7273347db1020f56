"""Synthetic PANDA-like scene generator (numpy).

Port of ``repro/data/synthetic.py``: the PANDA4K dataset is not
redistributable, so serving runs on synthetic gigapixel-camera-style scenes
calibrated to the paper's Table I statistics (RoI proportion ~2.6-14.2% of
the frame, tens to hundreds of small moving objects, a static textured
background, irregular object counts).  Rendering is deterministic per
(scene, frame) seed; the same seed renders the same frames as the JAX
package's generator.
"""
from __future__ import annotations

import dataclasses
import numpy as np

# (name, n_objects, mean object side in px at 4K, roi proportion target %)
# mirrors Table I's ten scenes
SCENE_PRESETS = [
    ("university_canteen", 25, 90, 5.45),
    ("oct_habour", 38, 90, 8.31),
    ("xili_crossroad", 55, 60, 5.91),
    ("primary_school", 24, 140, 14.16),
    ("basketball_court", 11, 120, 5.04),
    ("xinzhongguan", 90, 45, 5.23),
    ("university_campus", 25, 55, 2.59),
    ("xili_street_1", 48, 80, 9.63),
    ("xili_street_2", 30, 95, 8.75),
    ("huaqiangbei", 120, 50, 9.67),
]


@dataclasses.dataclass
class SceneConfig:
    name: str
    width: int = 960
    height: int = 540
    n_objects: int = 30
    obj_side: int = 24           # mean object side at render resolution
    fps: float = 10.0
    seed: int = 0
    speed: float = 3.0           # px / frame random walk scale
    burst_prob: float = 0.02     # irregular peaks (Fig. 3)
    n_clusters: int = 3          # crowds cluster (PANDA-like); most zones
    cluster_pull: float = 0.02   # stay background-only


ACTIVE_FRAC = 0.86          # stationary active fraction of the burst chain
_LOGNORM_AREA = 1.38        # E[side^2] inflation for sigma = 0.4


def preset(index: int, width: int = 960, height: int = 540,
           fps: float = 10.0) -> SceneConfig:
    """Calibrate mean object size so the scene hits its Table-I RoI
    proportion target at this resolution."""
    name, n_obj, _side4k, prop_pct = SCENE_PRESETS[index % len(SCENE_PRESETS)]
    target_area = prop_pct / 100.0 * width * height
    mean_area = target_area / (n_obj * ACTIVE_FRAC * _LOGNORM_AREA)
    side = max(4, int(mean_area ** 0.5))
    return SceneConfig(name=name, width=width, height=height,
                       n_objects=n_obj, obj_side=side, fps=fps, seed=index)


class Scene:
    """Moving-rectangle scene with textured static background."""

    def __init__(self, cfg: SceneConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        h, w = cfg.height, cfg.width
        # static textured background
        yy, xx = np.mgrid[0:h, 0:w]
        self.background = (
            0.35 + 0.15 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
            + 0.05 * rng.standard_normal((h, w))
        ).astype(np.float32).clip(0.0, 1.0)

        n = cfg.n_objects
        self.centers = rng.uniform([w * .15, h * .15], [w * .85, h * .85],
                                   size=(cfg.n_clusters, 2)).astype(np.float32)
        assign = rng.integers(0, cfg.n_clusters, n)
        self.home = self.centers[assign]
        spread = min(w, h) / 8.0
        self.pos = (self.home + rng.normal(0, spread, (n, 2))
                    ).astype(np.float32).clip([0, 0], [w, h])
        self.vel = rng.normal(0, cfg.speed, size=(n, 2)).astype(np.float32)
        sides = rng.lognormal(np.log(cfg.obj_side), 0.4, size=(n, 2))
        self.size = np.clip(sides, 4, min(h, w) // 3).astype(np.float32)
        self.shade = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
        self.active = np.ones(n, bool)
        self._rng = rng
        self.t = 0

    def step(self):
        cfg = self.cfg
        n = len(self.pos)
        self.vel += self._rng.normal(0, 0.5, size=(n, 2)).astype(np.float32)
        self.vel += cfg.cluster_pull * (self.home - self.pos)  # stay crowded
        self.vel = np.clip(self.vel, -3 * cfg.speed, 3 * cfg.speed)
        self.pos += self.vel
        # reflect at borders
        for d, limit in ((0, cfg.width), (1, cfg.height)):
            low = self.pos[:, d] < 0
            high = self.pos[:, d] > limit
            self.vel[low | high, d] *= -1
            self.pos[:, d] = np.clip(self.pos[:, d], 0, limit)
        # irregular bursts: asymmetric on/off chain with ~86% duty cycle
        r = self._rng.random(n)
        turn_off = self.active & (r < cfg.burst_prob)
        turn_on = ~self.active & (r < 6 * cfg.burst_prob)
        self.active = (self.active & ~turn_off) | turn_on
        if not self.active.any():
            self.active[0] = True
        self.t += 1

    def boxes(self) -> np.ndarray:
        """Ground-truth boxes (K, 4) xyxy of active objects."""
        w2 = self.size[:, 0] / 2
        h2 = self.size[:, 1] / 2
        b = np.stack([self.pos[:, 0] - w2, self.pos[:, 1] - h2,
                      self.pos[:, 0] + w2, self.pos[:, 1] + h2], axis=-1)
        b[:, 0::2] = b[:, 0::2].clip(0, self.cfg.width)
        b[:, 1::2] = b[:, 1::2].clip(0, self.cfg.height)
        b = b[self.active]
        keep = (b[:, 2] - b[:, 0] > 2) & (b[:, 3] - b[:, 1] > 2)
        return b[keep].astype(np.int32)

    def render(self) -> np.ndarray:
        """Grayscale frame (H, W) float32 with objects composited."""
        frame = self.background.copy()
        for i in np.nonzero(self.active)[0]:
            x0 = int(max(0, self.pos[i, 0] - self.size[i, 0] / 2))
            y0 = int(max(0, self.pos[i, 1] - self.size[i, 1] / 2))
            x1 = int(min(self.cfg.width, self.pos[i, 0] + self.size[i, 0] / 2))
            y1 = int(min(self.cfg.height, self.pos[i, 1] + self.size[i, 1] / 2))
            if x1 <= x0 or y1 <= y0:
                continue
            frame[y0:y1, x0:x1] = self.shade[i]
        return frame

    def render_rgb(self) -> np.ndarray:
        g = self.render()
        return np.stack([g, g * 0.9, g * 0.8], axis=-1)

    def frames(self, n: int):
        """Yield (t_seconds, frame, gt_boxes) for n frames."""
        for _ in range(n):
            self.step()
            yield self.t / self.cfg.fps, self.render(), self.boxes()

    def roi_proportion(self) -> float:
        b = self.boxes()
        if len(b) == 0:
            return 0.0
        area = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).sum()
        return float(area) / (self.cfg.width * self.cfg.height)
