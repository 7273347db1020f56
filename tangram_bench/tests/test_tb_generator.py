"""The traffic generator: deterministic per seed, the same sizes for
every seed, and the replay and live schedules as the traffic file says."""
import collections
import hashlib

import numpy as np
import pytest
import torch
from tb_fixtures import tiny_traffic

from tangram_bench.traffic import generator

CANVAS = 128


def digest(clips) -> str:
    h = hashlib.sha256()
    for c in clips:
        for px in c.pixels:
            h.update(px.tobytes())
        h.update(repr(c.rects).encode())
    return h.hexdigest()


def test_clips_are_deterministic_per_seed():
    t = tiny_traffic()
    a = generator.make_clips(t, 7, CANVAS, torch.device("cpu"))
    b = generator.make_clips(t, 7, CANVAS, torch.device("cpu"))
    c = generator.make_clips(t, 8, CANVAS, torch.device("cpu"))
    assert digest(a) == digest(b)
    assert digest(a) != digest(c)
    # the seed draws the pixels' noise, never the objects or the patches
    assert [x.rects for x in a] == [x.rects for x in c]


def test_frames_are_rgb_at_the_traffic_size():
    t = tiny_traffic()
    clips = generator.make_clips(t, 1, CANVAS, torch.device("cpu"))
    assert len(clips) == len(t["scenes"])
    for clip in clips:
        assert len(clip.pixels) == t["clip_frames"]
        for px, rects in zip(clip.pixels, clip.rects):
            assert px.shape == (t["height"], t["width"], 3)
            assert px.dtype == np.float32
            assert 0.0 <= px.min() and px.max() <= 1.0
            for x0, y0, x1, y1 in rects:
                assert 0 <= x0 < x1 <= t["width"]
                assert 0 <= y0 < y1 <= t["height"]
                assert x1 - x0 <= CANVAS and y1 - y0 <= CANVAS


def test_partition_follows_algorithm_1():
    boxes = np.array([[10, 10, 30, 40], [50, 20, 70, 30],
                      [300, 200, 320, 230]], np.int32)
    rects = generator.partition(boxes, 512, 288, 4, 4, 16)
    # the first two join zone 0 and enclose to an aligned rectangle; the
    # third is alone in its zone
    assert rects[0] == (10, 10, 74, 42)
    assert rects[1] == (300, 200, 332, 232)
    for x0, y0, x1, y1 in rects:
        assert (x1 - x0) % 16 == 0 and (y1 - y0) % 16 == 0


def replay_rounds(seed, rounds):
    t = tiny_traffic(backlog_frames_per_camera=rounds)
    clips = generator.make_clips(t, seed, CANVAS, torch.device("cpu"))
    book = generator.FrameBook(clips)
    return t, clips, list(generator.replay_frames(t, clips, book, seed))


def test_replay_backlog_is_due_at_once_in_rounds():
    t, clips, frames = replay_rounds(5, 4)
    assert len(frames) == 4 * len(clips)
    assert all(a == 0.0 for f in frames for a in f.t_arrive)
    assert all(p.t_gen == 0.0 for f in frames for p in f.patches)
    ids = [f.frame_id for f in frames]
    assert len(set(ids)) == len(ids)             # fresh ids every cycle
    n = len(clips)
    for r in range(4):
        cams = {f.patches[0].camera_id for f in frames[r * n:(r + 1) * n]
                if f.patches}
        assert len(cams) == len([f for f in frames[r * n:(r + 1) * n]
                                 if f.patches])


def test_every_seed_replays_the_same_sizes_in_another_order():
    def sizes(seed):
        _, _, frames = replay_rounds(seed, 4)    # two whole clip cycles
        return collections.Counter((p.w, p.h) for f in frames
                                   for p in f.patches), \
            tuple(f.patches[0].camera_id for f in frames if f.patches)
    runs = [sizes(s) for s in range(11, 17)]
    assert all(r[0] == runs[0][0] for r in runs)
    assert len({r[1] for r in runs}) > 1
    # the same cyclic order, rotated
    n = 3
    for _, order in runs:
        first = order[:n]
        assert sorted(first) == list(range(n))
        assert all((b - a) % n == 1 for a, b in zip(first, first[1:]))


def test_live_schedule_frame_clock_and_uplink():
    t = tiny_traffic("live", fps=4.0, bandwidth_mbps=2.0)
    clips = generator.make_clips(t, 3, CANVAS, torch.device("cpu"))
    book = generator.FrameBook(clips)
    events = generator.live_frames(t, clips, book, 3, seconds=2.0)
    by_cam = collections.defaultdict(list)
    for e in events:
        if e.patches:
            by_cam[e.patches[0].camera_id].append(e)
    phases = set()
    for cam, evs in by_cam.items():
        gens = sorted(e.patches[0].t_gen for e in evs)
        phase = gens[0] % (1.0 / t["fps"])
        phases.add(round(phase * len(clips) * t["fps"], 9))
        assert 0.0 <= phase < 1.0 / t["fps"]
        assert all(g < 2.0 for g in gens)
        # the frame clock: phase + k / fps for the frames that had patches
        ks = [round((g - phase) * t["fps"]) for g in gens]
        assert all(abs(g - (phase + k / t["fps"])) < 1e-9
                   for g, k in zip(gens, ks))
        # FIFO uplink: each patch arrives after its capture and after the
        # previous patch of the camera, by its bytes at the link's rate
        rate = t["bandwidth_mbps"] * 1e6 / 8
        free = 0.0
        for e in sorted(evs, key=lambda e: e.patches[0].t_gen):
            for p, arr in zip(e.patches, e.t_arrive):
                want = max(p.t_gen, free) + generator.patch_bytes(p) / rate
                assert arr == pytest.approx(want)
                free = arr
    # the cameras' clocks evenly staggered over one frame period
    assert phases <= {float(j) for j in range(len(clips))}
    arrivals = generator.live_arrivals(events)
    times = [a[0] for a in arrivals]
    assert times == sorted(times)


def test_live_schedule_is_deterministic_per_seed():
    t = tiny_traffic("live")
    clips = generator.make_clips(t, 3, CANVAS, torch.device("cpu"))

    def sched(seed):
        book = generator.FrameBook(clips)
        return [(a[0], a[2].x0, a[2].y0, a[2].camera_id) for a in
                generator.live_arrivals(generator.live_frames(
                    t, clips, book, seed, 3.0))]
    assert sched(4) == sched(4)
    assert len({tuple(sched(s)) for s in range(6)}) > 1


def test_large_seeds_are_taken():
    rng = generator.seed_rng(2**40 + 3)
    assert 0 <= int(rng.integers(0, 10)) < 10
    assert 0 <= generator.torch_seed(2**40 + 3, 9) < 2**63
