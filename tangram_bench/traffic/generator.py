"""The benchmark's traffic: camera clips and the arrival schedules drawn
from a traffic file and ``--seed``.

A frozen copy, in numpy and torch, of three pieces of the Tangram
reproduction, so that no later change to the program moves the traffic:

* the synthetic PANDA-like scene (Table I's ten presets: object counts,
  sizes calibrated to each scene's RoI proportion, crowds, bursts), whose
  pixels are rendered here on the device;
* Algorithm 1, adaptive frame partitioning (zones, the enclosing
  rectangle of each zone's RoIs, sizes aligned to 16, clamped to a
  canvas);
* the FIFO uplink that shapes each camera's patches at its bandwidth.

The edge's work is done here: the RoIs are the scene's own object boxes.
Each camera renders one clip of ``clip_frames`` frames in set-up and
cycles it with fresh frame ids.  The object dynamics follow the preset
(its seed is the scene index), so every ``--seed`` sends the same sizes
and the same arrivals, shifted: the seed draws the pixels' texture noise,
the clip frame every camera starts from, and a rotation of the cameras'
order in a replay round and of their slots on the live frame clock.

Nothing here imports the program: a patch is a plain
``(x0, y0, x1, y1, frame_id, camera_id, t_gen)`` record.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

# (name, n_objects, mean object side in px at 4K, roi proportion target %)
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
ACTIVE_FRAC = 0.86          # stationary active fraction of the burst chain
LOGNORM_AREA = 1.38         # E[side^2] inflation for sigma = 0.4

# the uplink's byte model: a 3840x2160 frame is about 1 MB
PATCH_HEADER_BYTES = 256
BPP_FG = 0.25               # bytes per pixel of a high-quality RoI crop

#: frame ids: camera << 32 | running frame number
CAMERA_SHIFT = 32


@dataclasses.dataclass(frozen=True)
class PatchRec:
    x0: int
    y0: int
    x1: int
    y1: int
    frame_id: int
    camera_id: int
    t_gen: float

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @property
    def area(self) -> int:
        return self.w * self.h


# ------------------------------------------------------------ the scene ----

class SceneDynamics:
    """The PANDA-like scene's moving objects (the preset's own seed): a
    random walk pulled toward crowd centres, reflected at the borders,
    with objects switching on and off in bursts."""

    def __init__(self, index: int, width: int, height: int):
        _, n, _, prop_pct = SCENE_PRESETS[index % len(SCENE_PRESETS)]
        target_area = prop_pct / 100.0 * width * height
        mean_area = target_area / (n * ACTIVE_FRAC * LOGNORM_AREA)
        self.obj_side = max(4, int(mean_area ** 0.5))
        self.width, self.height = width, height
        self.speed, self.burst_prob = 3.0, 0.02
        self.n_clusters, self.cluster_pull = 3, 0.02
        rng = np.random.default_rng(index)
        h, w = height, width
        self.centers = rng.uniform([w * .15, h * .15], [w * .85, h * .85],
                                   size=(self.n_clusters, 2)
                                   ).astype(np.float32)
        assign = rng.integers(0, self.n_clusters, n)
        self.home = self.centers[assign]
        spread = min(w, h) / 8.0
        self.pos = (self.home + rng.normal(0, spread, (n, 2))
                    ).astype(np.float32).clip([0, 0], [w, h])
        self.vel = rng.normal(0, self.speed, size=(n, 2)).astype(np.float32)
        sides = rng.lognormal(np.log(self.obj_side), 0.4, size=(n, 2))
        self.size = np.clip(sides, 4, min(h, w) // 3).astype(np.float32)
        self.shade = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
        self.active = np.ones(n, bool)
        self._rng = rng

    def step(self) -> None:
        n = len(self.pos)
        self.vel += self._rng.normal(0, 0.5, size=(n, 2)).astype(np.float32)
        self.vel += self.cluster_pull * (self.home - self.pos)
        self.vel = np.clip(self.vel, -3 * self.speed, 3 * self.speed)
        self.pos += self.vel
        for d, limit in ((0, self.width), (1, self.height)):
            low = self.pos[:, d] < 0
            high = self.pos[:, d] > limit
            self.vel[low | high, d] *= -1
            self.pos[:, d] = np.clip(self.pos[:, d], 0, limit)
        r = self._rng.random(n)
        turn_off = self.active & (r < self.burst_prob)
        turn_on = ~self.active & (r < 6 * self.burst_prob)
        self.active = (self.active & ~turn_off) | turn_on
        if not self.active.any():
            self.active[0] = True

    def boxes(self) -> np.ndarray:
        """(K, 4) int32 xyxy boxes of the active objects."""
        w2 = self.size[:, 0] / 2
        h2 = self.size[:, 1] / 2
        b = np.stack([self.pos[:, 0] - w2, self.pos[:, 1] - h2,
                      self.pos[:, 0] + w2, self.pos[:, 1] + h2], axis=-1)
        b[:, 0::2] = b[:, 0::2].clip(0, self.width)
        b[:, 1::2] = b[:, 1::2].clip(0, self.height)
        b = b[self.active]
        keep = (b[:, 2] - b[:, 0] > 2) & (b[:, 3] - b[:, 1] > 2)
        return b[keep].astype(np.int32)

    def rects(self) -> List[Tuple[int, int, int, int, float]]:
        """The rectangles the renderer composites, (x0, y0, x1, y1,
        shade), in object order."""
        out = []
        for i in np.nonzero(self.active)[0]:
            x0 = int(max(0, self.pos[i, 0] - self.size[i, 0] / 2))
            y0 = int(max(0, self.pos[i, 1] - self.size[i, 1] / 2))
            x1 = int(min(self.width, self.pos[i, 0] + self.size[i, 0] / 2))
            y1 = int(min(self.height, self.pos[i, 1] + self.size[i, 1] / 2))
            if x1 > x0 and y1 > y0:
                out.append((x0, y0, x1, y1, float(self.shade[i])))
        return out


def background(width: int, height: int, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """The static textured background, (H, W) float32 on ``device``."""
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    noise = torch.randn((height, width), generator=generator, device=device)
    return (0.35 + 0.15 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)
            + 0.05 * noise).clamp_(0.0, 1.0)


def render_rgb(bg: torch.Tensor, rects) -> np.ndarray:
    """The frame: objects composited over the background, as (H, W, 3)
    float32 RGB on the host (g, 0.9 g, 0.8 g)."""
    g = bg.clone()
    for x0, y0, x1, y1, shade in rects:
        g[y0:y1, x0:x1] = shade
    rgb = torch.stack([g, g * 0.9, g * 0.8], dim=-1)
    return rgb.cpu().numpy()


# ---------------------------------------------------------- Algorithm 1 ----

def align_up(lo: int, hi: int, limit: int, align: int = 16
             ) -> Tuple[int, int]:
    size = -(-(hi - lo) // align) * align
    hi = min(lo + size, limit)
    lo = max(hi - size, 0)
    return lo, hi


def partition(boxes: np.ndarray, width: int, height: int, zone_x: int,
              zone_y: int, align: int = 16
              ) -> List[Tuple[int, int, int, int]]:
    """Each RoI joins the zone it overlaps most (the first on a tie); each
    non-empty zone becomes the aligned rectangle enclosing its RoIs, in
    zone order."""
    zw, zh = width // zone_x, height // zone_y
    zones: Dict[int, list] = {}
    for (x0, y0, x1, y1) in boxes:
        best, best_area = None, 0
        for zyi in range(zone_y):
            for zxi in range(zone_x):
                ox = max(0, min(x1, (zxi + 1) * zw) - max(x0, zxi * zw))
                oy = max(0, min(y1, (zyi + 1) * zh) - max(y0, zyi * zh))
                if ox * oy > best_area:
                    best_area = ox * oy
                    best = zyi * zone_x + zxi
        if best is not None:
            zones.setdefault(best, []).append((x0, y0, x1, y1))
    out = []
    for _, bs in sorted(zones.items()):
        x0, x1 = align_up(min(b[0] for b in bs), max(b[2] for b in bs),
                          width, align)
        y0, y1 = align_up(min(b[1] for b in bs), max(b[3] for b in bs),
                          height, align)
        out.append((int(x0), int(y0), int(x1), int(y1)))
    return out


def cut_patches(boxes: np.ndarray, traffic: dict, canvas: int
                ) -> List[Tuple[int, int, int, int]]:
    """Algorithm 1 on one frame's RoIs, each patch clamped to one canvas
    tile (the edge pipeline's clamp)."""
    zx, zy = traffic["zones"]
    rects = partition(boxes, traffic["width"], traffic["height"], zx, zy,
                      traffic["align"])
    return [(x0, y0, min(x1, x0 + canvas), min(y1, y0 + canvas))
            for x0, y0, x1, y1 in rects]


# --------------------------------------------------------------- uplink ----

def patch_bytes(p: PatchRec) -> float:
    return PATCH_HEADER_BYTES + p.area * BPP_FG


class Uplink:
    """One camera's FIFO link: a patch arrives at max(t_gen, link free)
    + bytes / bandwidth, in send order."""

    def __init__(self, bandwidth_bps: float):
        self.byte_rate = bandwidth_bps / 8.0
        self.link_free = 0.0

    def send(self, p: PatchRec) -> float:
        start = max(p.t_gen, self.link_free)
        self.link_free = start + patch_bytes(p) / self.byte_rate
        return self.link_free


# ---------------------------------------------------------------- clips ----

@dataclasses.dataclass
class Clip:
    """One camera's clip: the scene index, its frames' RGB pixels and each
    frame's patches as (x0, y0, x1, y1)."""
    camera: int
    scene: int
    pixels: List[np.ndarray]
    rects: List[List[Tuple[int, int, int, int]]]


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 63))


def torch_seed(seed: int, salt: int) -> int:
    return (int(seed) * 1_000_003 + salt) % (1 << 63)


def make_clips(traffic: dict, seed: int, canvas: int,
               device: torch.device) -> List[Clip]:
    """Render every camera's clip once: ``warm_steps`` steps of the scene,
    then ``clip_frames`` frames, each with its patches."""
    clips = []
    for cam, scene in enumerate(traffic["scenes"]):
        dyn = SceneDynamics(scene, traffic["width"], traffic["height"])
        gen = torch.Generator(device=device)
        gen.manual_seed(torch_seed(seed, cam))
        bg = background(traffic["width"], traffic["height"], gen, device)
        for _ in range(traffic["warm_steps"]):
            dyn.step()
        pixels, rects = [], []
        for _ in range(traffic["clip_frames"]):
            dyn.step()
            rects.append(cut_patches(dyn.boxes(), traffic, canvas))
            pixels.append(render_rgb(bg, dyn.rects()))
        clips.append(Clip(cam, scene, pixels, rects))
    return clips


class FrameBook:
    """Frame id -> the clip frame it shows (frames are cycled, so ids are
    fresh and the pixels shared)."""

    def __init__(self, clips: Sequence[Clip]):
        self.clips = list(clips)
        self.frame_of: Dict[int, Tuple[int, int]] = {}
        self._next = [0] * len(self.clips)

    def new_frame(self, cam: int, clip_idx: int) -> int:
        fid = (cam << CAMERA_SHIFT) | self._next[cam]
        self._next[cam] += 1
        self.frame_of[fid] = (cam, clip_idx)
        return fid

    def pixels(self, frame_id: int) -> np.ndarray:
        cam, idx = self.frame_of[frame_id]
        return self.clips[cam].pixels[idx]


# ------------------------------------------------------------ schedules ----

@dataclasses.dataclass
class FrameEvent:
    """One frame as the cloud sees it: its id, pixels and the arrival time
    of each of its patches."""
    frame_id: int
    pixels: np.ndarray
    patches: List[PatchRec]
    t_arrive: List[float]


def replay_frames(traffic: dict, clips: Sequence[Clip], book: FrameBook,
                  seed: int) -> Iterator[FrameEvent]:
    """The recorded backlog, all due at t = 0: rounds of one frame a
    camera (cameras in a seeded order), each camera stepping through its
    clip from a seeded start, ``backlog_frames_per_camera`` rounds."""
    rng = seed_rng(seed)
    order = np.roll(np.arange(len(clips)), int(rng.integers(len(clips))))
    start = int(rng.integers(traffic["clip_frames"]))
    for r in range(traffic["backlog_frames_per_camera"]):
        for cam in order:
            clip = clips[cam]
            idx = (start + r) % traffic["clip_frames"]
            fid = book.new_frame(int(cam), idx)
            patches = [PatchRec(*rect, fid, int(cam), 0.0)
                       for rect in clip.rects[idx]]
            yield FrameEvent(fid, clip.pixels[idx], patches,
                             [0.0] * len(patches))


def live_frames(traffic: dict, clips: Sequence[Clip], book: FrameBook,
                seed: int, seconds: float) -> List[FrameEvent]:
    """Every frame captured in ``[0, seconds)``: the cameras' frame clocks
    evenly staggered, camera c's frames at ``slot_c / (n fps) + k / fps``
    (the slots a seeded rotation of the cameras), each frame's patches
    sent through the camera's uplink; sorted by first arrival."""
    rng = seed_rng(seed)
    fps = float(traffic["fps"])
    n = len(clips)
    shift = int(rng.integers(n))
    phase = [((c + shift) % n) / (n * fps) for c in range(n)]
    start = int(rng.integers(traffic["clip_frames"]))
    bps = traffic["bandwidth_mbps"] * 1e6
    events = []
    for cam, clip in enumerate(clips):
        link = Uplink(bps)
        k = 0
        while True:
            t = float(phase[cam]) + k / fps
            if t >= seconds:
                break
            idx = (start + k) % traffic["clip_frames"]
            fid = book.new_frame(cam, idx)
            patches = [PatchRec(*rect, fid, cam, t)
                       for rect in clip.rects[idx]]
            events.append(FrameEvent(fid, clip.pixels[idx], patches,
                                     [link.send(p) for p in patches]))
            k += 1
    events.sort(key=lambda e: (e.t_arrive[0] if e.t_arrive else math.inf,
                               e.frame_id))
    return events


def live_arrivals(events: Sequence[FrameEvent]
                  ) -> List[Tuple[float, int, PatchRec, FrameEvent]]:
    """(t_arrive, order, patch, frame) over every camera, in arrival
    order (ties: camera, then send order)."""
    out = []
    for e in events:
        for p, t in zip(e.patches, e.t_arrive):
            out.append((t, len(out), p, e))
    out.sort(key=lambda a: (a[0], a[2].camera_id, a[1]))
    return out
