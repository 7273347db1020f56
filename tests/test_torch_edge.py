"""The edge pipeline: GMM background subtraction, RoI extraction and the
synthetic camera's arrivals, port (plain PyTorch on the CPU) against the
JAX package on the same rendered frames.

GMM foreground masks are compared exactly: both sides evaluate the same
float32 elementwise expressions, and on these scenes XLA's CPU code gives
the same bits as PyTorch's.  (XLA may rewrite ``w / sqrt(var)`` as
``w * rsqrt(var)`` on other backends, which could flip a pixel whose
fitness ranks tie to the last bit; the card's run is therefore never
compared against the JAX masks, and the serve parity tests feed both
engines the same arrivals.)  The mixture state is compared at 1e-6."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as jgmm
from repro.core import rois as jrois
from repro.data.synthetic import Scene as JScene
from repro.data.synthetic import preset as jpreset
from repro.sources import RateProfile as JRateProfile
from repro.sources import make_source as jmake_source
from repro_torch.core import gmm as tgmm
from repro_torch.core import rois as trois
from repro_torch.data.synthetic import Scene, preset
from repro_torch.sources import RateProfile, make_source
from repro_torch.sources.camera import EdgePipeline


def _frames(n, scene=0, width=256, height=128):
    js = JScene(jpreset(scene, width=width, height=height))
    ts = Scene(preset(scene, width=width, height=height))
    out = []
    for _ in range(n):
        js.step()
        ts.step()
        jf, tf = js.render(), ts.render()
        np.testing.assert_array_equal(tf, jf)      # same scene generator
        out.append(jf)
    return out


def _gmm_masks(frames):
    jstate = jgmm.init_state(*frames[0].shape)
    tstate = tgmm.init_state(*frames[0].shape, device="cpu")
    pairs = []
    for f in frames:
        jstate, jfg = jgmm.update_jit(jstate, jnp.asarray(f))
        tstate, tfg = tgmm.update(tstate, torch.from_numpy(f))
        pairs.append((np.array(jfg), tfg.numpy()))
    for key in ("w", "mu", "var"):
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), atol=1e-6)
    return pairs


@pytest.mark.parametrize("scene", [0, 3])
def test_gmm_foreground_matches_jax(scene):
    pairs = _gmm_masks(_frames(24, scene=scene))
    for jfg, tfg in pairs:
        assert tfg.dtype == np.bool_
        np.testing.assert_array_equal(tfg, jfg)
    assert any(j.any() for j, _ in pairs[10:])   # the scene has foreground


@pytest.mark.parametrize("degraded", [False, True])
def test_extract_rois_matches_jax_on_scene_masks(degraded):
    cfg_j = jrois.RoIConfig()
    cfg_t = trois.RoIConfig()
    if degraded:
        cfg_j, cfg_t = cfg_j.degraded(), cfg_t.degraded()
    for jfg, _ in _gmm_masks(_frames(20))[10:]:
        jb, jv = jrois.extract_rois_jit(jnp.asarray(jfg), cfg_j)
        tb, tv = trois.extract_rois(torch.from_numpy(jfg), cfg_t)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert tb.dtype == torch.int32


def test_extract_rois_breaks_count_ties_like_top_k():
    """Five one-cell components of equal size and max_rois=3: the kept
    three must be the lowest labels, as jax.lax.top_k keeps them."""
    mask = np.zeros((64, 64), bool)
    for y, x in [(5, 60), (20, 3), (20, 40), (44, 12), (60, 60)]:
        mask[y, x] = True
    kw = dict(downsample=8, dilate=0, max_rois=3, min_area=1)
    jb, jv = jrois.extract_rois(jnp.asarray(mask), jrois.RoIConfig(**kw))
    tb, tv = trois.extract_rois(torch.from_numpy(mask),
                                trois.RoIConfig(**kw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.all()
    assert tb[:, :2].tolist() == [[56, 0], [0, 16], [40, 16]]


def test_extract_rois_matches_numpy_reference():
    rng = np.random.default_rng(5)
    mask = rng.random((128, 256)) < 0.002
    cfg = trois.RoIConfig(max_rois=64)
    tb, tv = trois.extract_rois(torch.from_numpy(mask), cfg)
    nb, _ = jrois.numpy_rois(mask, jrois.RoIConfig(max_rois=64))
    got = sorted(map(tuple, tb[tv].tolist()))
    assert got == sorted(map(tuple, nb.tolist()))


@pytest.mark.parametrize("kw", [
    dict(n_frames=16, canvas=128, slo=5.0),
    dict(n_frames=20, canvas=128, slo=0.5, scene=2, n_cameras=2),
    dict(n_frames=14, canvas=64, slo=1.0, bandwidth_bps=4e6),
    dict(n_frames=30, canvas=64, slo=1.0, rate="bursty")])
def test_synthetic_camera_arrivals_match_jax(kw):
    jframes, tframes = {}, {}
    if kw.get("rate") == "bursty":      # diurnal cycle + seeded bursts
        rate = dict(fps=8.0, diurnal_amplitude=0.5, diurnal_period_s=2.0,
                    burst_prob=0.3, burst_factor=2.5, seed=4)
        jkw = dict(kw, rate=JRateProfile(**rate))
        kw = dict(kw, rate=RateProfile(**rate))
    else:
        jkw = kw
    jsrc = jmake_source("synthetic", frame_sink=lambda f, px, n:
                        jframes.__setitem__(f, (px, n)), **jkw)
    tsrc = make_source("synthetic", device="cpu", frame_sink=lambda f, px, n:
                       tframes.__setitem__(f, (px, n)), **kw)
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


def test_source_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        src = make_source("synthetic", n_frames=2, canvas=64)
        assert src.pipeline.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_source("synthetic", n_frames=2, canvas=64)


@pytest.mark.parametrize("make", [
    lambda **kw: tgmm.init_state(8, 16, **kw)["w"].device,
    lambda **kw: EdgePipeline(8, 16, canvas=8, **kw).state["mu"].device],
    ids=["gmm.init_state", "EdgePipeline"])
def test_edge_entry_points_default_to_cuda(make):
    assert make(device="cpu").type == "cpu"
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
