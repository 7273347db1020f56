"""The file-stream source: recordings read by ``load_frames``, replayed
through the edge pipeline by ``FileStreamSource`` and served by
``--source file``, the port (plain PyTorch on the CPU) against the JAX
package on the same recordings (seeded, written to ``tmp_path``)."""
import dataclasses
import re

import numpy as np
import pytest

from repro.data import video as jvideo
from repro.data.synthetic import Scene as JScene
from repro.data.synthetic import preset as jpreset
from repro.launch import serve as jserve
from repro.sources import RateProfile as JRateProfile
from repro.sources import make_source as jmake_source
from repro_torch.data import video
from repro_torch.launch import serve as tserve
from repro_torch.sources import FileStreamSource, RateProfile, make_source


def _recording(path, n=14, width=256, height=128, scene=0, uint8=True):
    """A seeded synthetic clip as a (T, H, W) stack: 8-bit by default, as
    a camera would record it."""
    sc = JScene(jpreset(scene, width=width, height=height))
    frames = []
    for _ in range(n):
        sc.step()
        frames.append(sc.render())
    stack = np.stack(frames)
    if uint8:
        stack = np.round(stack * 255).astype(np.uint8)
    np.save(path, stack)
    return path


def _formats(tmp_path):
    rng = np.random.default_rng(7)
    stack = (rng.random((3, 8, 10)) * 255).astype(np.uint8)
    unit = rng.random((3, 8, 10)).astype(np.float32)
    out = {}
    np.save(tmp_path / "u8.npy", stack)
    out["npy-uint8"] = tmp_path / "u8.npy"
    np.save(tmp_path / "unit.npy", unit)
    out["npy-float"] = tmp_path / "unit.npy"
    np.save(tmp_path / "one.npy", unit[0])
    out["npy-single-frame"] = tmp_path / "one.npy"
    np.save(tmp_path / "rgb.npy", rng.random((2, 8, 10, 3)))
    out["npy-rgb"] = tmp_path / "rgb.npy"
    np.save(tmp_path / "rgb8.npy",
            rng.integers(0, 256, (2, 8, 10, 3)).astype(np.uint8))
    out["npy-rgb-uint8"] = tmp_path / "rgb8.npy"
    np.savez(tmp_path / "named.npz", other=unit[:1], frames=stack)
    out["npz-frames"] = tmp_path / "named.npz"
    np.savez(tmp_path / "first.npz", unit, stack)
    out["npz-first"] = tmp_path / "first.npz"
    d = tmp_path / "dir"
    d.mkdir()
    for i in (2, 0, 1):
        np.save(d / f"{i:03d}.npy", stack[i])
    out["directory"] = d
    return out


FORMATS = ["npy-uint8", "npy-float", "npy-single-frame", "npy-rgb",
           "npy-rgb-uint8", "npz-frames", "npz-first", "directory"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_frames_matches_jax(fmt, tmp_path):
    path = _formats(tmp_path)[fmt]
    got = video.load_frames(path)
    want = jvideo.load_frames(path)
    assert got.dtype == np.float32 and got.ndim == 3
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_load_frames_rejects_what_it_cannot_read(tmp_path):
    np.save(tmp_path / "bad.npy", np.zeros((2, 3, 8, 10, 3), np.float32))
    empty = tmp_path / "empty"
    empty.mkdir()
    for path in (tmp_path / "bad.npy", empty):
        with pytest.raises(ValueError):
            jvideo.load_frames(path)
        with pytest.raises(ValueError):
            video.load_frames(path)


@pytest.mark.parametrize("w,h,fg", [(3840, 2160, 0), (3840, 2160, 250000),
                                    (2048, 1024, 4096), (7, 13, 91)])
def test_frame_bytes_match_jax(w, h, fg):
    assert video.frame_bytes(w, h) == jvideo.frame_bytes(w, h)
    assert (video.masked_frame_bytes(w, h, fg)
            == jvideo.masked_frame_bytes(w, h, fg))
    assert video.masked_frame_bytes(w, h, 0) < video.frame_bytes(w, h)


@pytest.mark.parametrize("kw", [
    dict(canvas=128),
    dict(canvas=128, n_frames=30, rate="fast"),    # loops the 14 frames
    dict(canvas=64, slo=0.5, camera_id=3, bandwidth_bps=4e6),
], ids=["whole", "looping", "camera3"])
def test_file_stream_arrivals_match_jax(kw, tmp_path):
    path = _recording(tmp_path / "clip.npy")
    if kw.get("rate") == "fast":
        kw = dict(kw, warmup_s=0.2)
        jkw = dict(kw, rate=JRateProfile(fps=20.0))
        kw = dict(kw, rate=RateProfile(fps=20.0))
    else:
        jkw = kw
    jframes, tframes = {}, {}
    jsrc = jmake_source("file", path=path, frame_sink=lambda f, px, n:
                        jframes.__setitem__(f, (px, n)), **jkw)
    tsrc = make_source("file", path=path, device="cpu",
                       frame_sink=lambda f, px, n:
                       tframes.__setitem__(f, (px, n)), **kw)
    assert isinstance(tsrc, FileStreamSource)
    want = list(jsrc.events(None))
    got = list(tsrc.events(None))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.t_arrive == w.t_arrive and g.n_bytes == w.n_bytes
        assert dataclasses.astuple(g.patch) == dataclasses.astuple(w.patch)
    assert set(tframes) == set(jframes)
    for fid, (px, n) in tframes.items():
        assert n == jframes[fid][1]
        np.testing.assert_array_equal(px, jframes[fid][0])
    assert tsrc.stats().to_dict() == jsrc.stats().to_dict()
    assert tsrc.stats().kind == "file"
    n_frames = kw.get("n_frames", 14)
    assert tsrc.stats().frames_total == n_frames
    cam = kw.get("camera_id", 0)
    assert all(fid >> 20 == cam for fid in tframes)
    assert max(fid & 0xFFFFF for fid in tframes) == n_frames - 1


def test_file_stream_takes_gmm_impl(tmp_path):
    path = _recording(tmp_path / "clip.npy", n=4)
    src = make_source("file", path=path, device="cpu", gmm_impl="torch")
    assert src.pipeline.gmm_impl == "torch"
    with pytest.raises(ValueError, match="unknown gmm impl"):
        make_source("file", path=path, device="cpu", gmm_impl="xla")


def _served(out: str):
    m = re.search(r"served (\d+) patches in (\d+) invocations.*routed "
                  r"(\d+) detections.*\((\d+) frames still held", out)
    assert m, out
    return tuple(int(x) for x in m.groups())


def test_serve_cli_file_source_matches_jax_driver(tmp_path, capsys):
    """The same recording through both drivers: the same patches served,
    every frame released.  Invocation boundaries follow each driver's
    measured latency table, and the drivers' built-in detectors draw
    their random weights from different generators, so invocations and
    routed detections are held against the JAX engine with a fixed table
    and the same (converted) weights in ``tests/test_torch_serve.py``'s
    ``file`` trace instead."""
    path = _recording(tmp_path / "clip.npy")
    args = ["--source", "file", "--frames-path", str(path), "--frames",
            "14", "--canvas", "128"]
    jserve.main(args)
    want = _served(capsys.readouterr().out)
    tserve.main(["--device", "cpu"] + args)
    out = capsys.readouterr().out
    got = _served(out)
    assert got[0] == want[0] > 0                 # patches served
    assert got[1] >= 1 and want[1] >= 1          # invocations
    assert got[3] == want[3] == 0                # frames still held
    assert "source file: 14 frames" in out


def test_serve_cli_file_source_needs_a_path(capsys):
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--source", "file"]
                 if main is tserve.main else ["--source", "file"])
        assert "--source file requires --frames-path" in \
            capsys.readouterr().err
