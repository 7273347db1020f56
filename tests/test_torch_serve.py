"""The slice as a whole: the port's serving engine + device executors on
the CPU against the JAX package's, fed the same arrivals and frames (from
the JAX synthetic camera, or its file-stream source replaying a recording),
the same detector weights (converted) and one fixed latency table, so
invocation boundaries cannot depend on timing.

Required: identical invocation boundaries, equal routed detections
(scores within 1e-4, boxes within 1e-3 px; detections whose score lies
within 1e-3 of the 0.5 threshold are excluded, since float32 summation
order may move them across it), bit-equal evidence pixels, 0 frames held.
The fused path (``fuse=True``) is held against the JAX fused executor on
its XLA path (its Pallas stitch->embed cannot run here, ROADMAP F1).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import DeviceExecutor as JDeviceExecutor
from repro.core.engine import ServingEngine as JServingEngine
from repro.core.engine import uniform_pool as juniform_pool
from repro.core.latency import LatencyTable as JLatencyTable
from repro.launch import serve as jserve
from repro.data.synthetic import Scene as JScene
from repro.data.synthetic import preset as jpreset
from repro.models import detector as jdet
from repro.sources import make_source as jmake_source
from repro_torch.config import DetectorConfig
from repro_torch.core.engine import ServingEngine, make_executor, uniform_pool
from repro_torch.core.latency import LatencyTable
from repro_torch.core.partitioning import Patch
from repro_torch.data.video import Arrival
from repro_torch.launch import serve as tserve
from repro_torch.models import detector as tdet

CANVAS = 128
TABLE = {1: (0.02, 0.002), 2: (0.03, 0.002), 4: (0.05, 0.004)}
TRACES = {
    "loose": dict(n_frames=16, canvas=CANVAS, slo=5.0),
    "tight": dict(n_frames=24, canvas=CANVAS, slo=0.3, n_cameras=2,
                  scene=3),
    # an 8-bit recording of scene 1 through the file-stream source
    "file": dict(n_frames=20, canvas=CANVAS, slo=1.0),
}


@pytest.fixture(scope="module")
def detector():
    """The JAX driver's detector, its zero/one inits perturbed so that the
    head fires on some cells (the raw init routes no detections)."""
    cfg, params, serve_fn, rules = jserve.build_detector(canvas=CANVAS)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        x + jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        for x in leaves])
    tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(DetectorConfig)})
    tparams = tdet.convert_params(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, torch.device("cpu"))
    return (params, serve_fn, cfg, rules), (tparams, tdet.serve_fn(tcfg),
                                            tcfg)


def _recording(path, n=16, scene=1):
    sc = JScene(jpreset(scene, width=2 * CANVAS, height=CANVAS))
    frames = []
    for _ in range(n):
        sc.step()
        frames.append(sc.render())
    np.save(path, np.round(np.stack(frames) * 255).astype(np.uint8))
    return path


@pytest.fixture(scope="module", params=sorted(TRACES))
def trace(request, tmp_path_factory):
    frames = {}
    kind, kw = "synthetic", TRACES[request.param]
    if request.param == "file":
        path = _recording(tmp_path_factory.mktemp("recording") / "clip.npy")
        kind, kw = "file", dict(kw, path=path)
    src = jmake_source(kind, frame_sink=lambda f, px, n:
                       frames.__setitem__(f, (px, n)), **kw)
    return list(src.events(None)), frames


def _capture(ex):
    routed, pixels = {}, {}
    release = ex.on_complete

    def on_complete(comp):
        per_frame, per_frame_pixels = comp.outputs
        for fid, dets in per_frame.items():
            routed.setdefault(fid, []).extend(dets)
        for fid, px in per_frame_pixels.items():
            pixels.setdefault(fid, []).extend(px)
        release(comp)

    ex.on_complete = on_complete
    return routed, pixels


def _result(engine, ex, routed, pixels):
    return {"bounds": [[(p.frame_id, p.x0, p.y0, p.x1, p.y1)
                        for p in inv.patches] for inv in engine.invocations],
            "routed": routed, "pixels": pixels, "held": len(ex.frames),
            "patches": len(engine.outcomes),
            "fused": getattr(ex, "n_fused", 0)}


def _run_jax(trace, detector, use_pallas, fuse=False):
    arrivals, frames = trace
    params, serve_fn, cfg, rules = detector[0]
    fused = {}
    if fuse:
        kernel, bias = jdet.embed_params(cfg, params)
        fused = dict(fuse=True, embed_kernel=kernel, embed_bias=bias,
                     patch=cfg.patch, tokens_fn=jax.jit(
                         lambda p, t: jdet.forward_tokens(cfg, p, t, rules)))
    ex = JDeviceExecutor(serve_fn, params, CANVAS, CANVAS,
                         use_pallas=use_pallas, clock=lambda: 0.0, **fused)
    routed, pixels = _capture(ex)
    for fid, (px, n) in frames.items():
        ex.add_frame(fid, px, n)
    engine = JServingEngine(juniform_pool(CANVAS, CANVAS,
                                          JLatencyTable(dict(TABLE)),
                                          max_canvases=4), ex)
    engine.run(arrivals)
    return _result(engine, ex, routed, pixels)


def _run_port(trace, detector, executor, fuse=False):
    arrivals, frames = trace
    params, serve_fn, cfg = detector[1]
    fused = tserve.fused_kwargs(cfg, params) if fuse else {}
    ex = make_executor(executor, serve_fn=serve_fn, params=params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device="cpu",
                       clock=lambda: 0.0, max_inflight=2, **fused)
    routed, pixels = _capture(ex)
    for fid, (px, n) in frames.items():
        ex.add_frame(fid, px, n)
    engine = ServingEngine(uniform_pool(CANVAS, CANVAS,
                                        LatencyTable(dict(TABLE)),
                                        max_canvases=4), ex,
                           check_invariants=True)
    engine.run([Arrival(a.t_arrive, Patch(**dataclasses.asdict(a.patch)),
                        a.n_bytes) for a in arrivals])
    return _result(engine, ex, routed, pixels)


def _margin_filter(per_frame, threshold=0.5, margin=1e-3):
    out = {}
    for fid, dets in per_frame.items():
        kept = [(s, b) for s, b in dets if abs(s - threshold) >= margin]
        if kept:
            out[fid] = kept
    return out


def _assert_same(got, want):
    assert got["bounds"] == want["bounds"]
    assert got["held"] == want["held"] == 0
    assert got["patches"] == want["patches"]
    g, w = _margin_filter(got["routed"]), _margin_filter(want["routed"])
    assert set(g) == set(w)
    for fid in w:
        assert len(g[fid]) == len(w[fid]), fid
        for (gs, gb), (ws, wb) in zip(g[fid], w[fid]):
            assert gs == pytest.approx(ws, abs=1e-4)
            assert gb == pytest.approx(wb, abs=1e-3)
    assert set(got["pixels"]) == set(want["pixels"])
    for fid in want["pixels"]:
        assert len(got["pixels"][fid]) == len(want["pixels"][fid])
        for a, b in zip(got["pixels"][fid], want["pixels"][fid]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("executor", ["device", "async_device"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_port_engine_matches_jax_engine(trace, detector, use_pallas,
                                        executor):
    want = _run_jax(trace, detector, use_pallas)
    got = _run_port(trace, detector, executor)
    assert len(want["bounds"]) >= 1 and want["patches"] > 0
    assert sum(len(v) for v in want["routed"].values()) > 0
    _assert_same(got, want)


@pytest.mark.parametrize("executor", ["device", "async_device"])
def test_port_fused_engine_matches_jax_fused_engine(trace, detector,
                                                    executor):
    """The same engine parity with ``fuse=True`` on both sides: K4/K3's
    plain versions behind the port's executors against the JAX fused
    executor's XLA path."""
    want = _run_jax(trace, detector, use_pallas=False, fuse=True)
    got = _run_port(trace, detector, executor, fuse=True)
    assert want["fused"] == got["fused"] == len(want["bounds"]) >= 1
    assert sum(len(v) for v in want["routed"].values()) > 0
    _assert_same(got, want)


def _summary(out: str):
    """(patches served N, invocations M, routed detections D, MB of patch
    evidence, frames still held) of a driver's summary line."""
    m = re.search(r"served (\d+) patches in (\d+) invocations.*routed "
                  r"(\d+) detections \+ ([\d.]+) MB patch evidence.*"
                  r"\((\d+) frames still held", out)
    assert m, out
    return (int(m[1]), int(m[2]), int(m[3]), float(m[4]), int(m[5]))


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's driver serves the JAX driver's own detector weights
    (``jax.random.PRNGKey(0)``, through ``convert_params``), so both
    drivers' summary lines can be held equal on invocations and routed
    detections too."""
    def build(canvas=256, quantize=False, device=None):
        cfg, params, _, _ = jserve.build_detector(canvas, quantize=quantize)
        tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(DetectorConfig)})
        tparams = tdet.convert_params(
            jax.tree_util.tree_map(np.asarray, params), tcfg,
            torch.device("cpu"))
        return tcfg, tparams, tdet.serve_fn(tcfg)
    monkeypatch.setattr(tserve, "build_detector", build)


def _assert_same_summary(got, want):
    """N, M, D, the evidence MB and 0 frames held equal; SLO violations
    follow each host's profiled latency table and are not compared."""
    assert got == want, (got, want)
    assert got[4] == 0


@pytest.mark.parametrize("executor", [[], ["--async-device"]])
@pytest.mark.parametrize("frames", ["16", "2"])
def test_serve_cli_matches_jax_driver(frames, executor, jax_weights,
                                      capsys):
    args = ["--frames", frames, "--canvas", "128", "--slo", "5.0"]
    jserve.main(args + executor)
    want = _summary(capsys.readouterr().out)
    tserve.main(["--device", "cpu"] + args + executor)
    got = _summary(capsys.readouterr().out)
    _assert_same_summary(got, want)
    if frames == "2":
        assert got[:2] == (0, 0)                 # the zero-patch path
    else:
        assert got[0] > 0


@pytest.mark.parametrize("executor", [[], ["--async-device"]])
def test_serve_cli_fused_matches_jax_serve(executor, jax_weights, capsys):
    args = ["--fuse", "--frames", "16", "--canvas", "128", "--slo", "5.0"]
    jserve.main(args + executor)
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu"] + args + executor)
    got = capsys.readouterr().out
    assert ", fused" in want and ", fused" in got
    _assert_same_summary(_summary(got), _summary(want))
    assert _summary(got)[0] > 0


@pytest.mark.parametrize("fuse", [[], ["--fuse"]])
def test_serve_cli_quantized_matches_jax_driver(fuse, jax_weights, capsys):
    """``--quantize``: both drivers serve the JAX driver's weights
    quantized (the port through ``convert_params`` of the JAX int8 tree)
    and print the same N, M, D and evidence, with ", int8"."""
    args = ["--quantize", "--frames", "16", "--canvas", "128", "--slo",
            "5.0"] + fuse
    jserve.main(args)
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu"] + args)
    got = capsys.readouterr().out
    assert ", int8" in want and ", int8" in got
    assert (", fused" in got) == bool(fuse)
    _assert_same_summary(_summary(got), _summary(want))
    assert _summary(got)[0] > 0


def test_serve_cli_quantize_builds_int8_weights(capsys):
    """The port's own ``--quantize`` build: int8 trunk kernels quantized
    from the fp weights ``build_detector`` draws without it."""
    cfg, params, _ = tserve.build_detector(128, device="cpu")
    qcfg, qparams, _ = tserve.build_detector(128, quantize=True,
                                             device="cpu")
    assert qcfg.quant_weights and not cfg.quant_weights
    wq = qparams["trunk"]["layers"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    fp = params["trunk"]["layers"][0]["attn"]["wq"]
    assert torch.allclose(wq["q"].float() * wq["scale"], fp,
                          atol=float(wq["scale"].max()) / 2 + 1e-7)
    tserve.main(["--device", "cpu", "--quantize", "--frames", "16",
                 "--canvas", "128", "--slo", "5.0"])
    out = capsys.readouterr().out
    assert ", int8" in out and _summary(out)[0] > 0 and _summary(out)[4] == 0


def test_serve_cli_async_and_live_source(capsys):
    tserve.main(["--device", "cpu", "--frames", "16", "--canvas", "128",
                 "--slo", "5.0", "--async-device", "--source", "synthetic",
                 "--use-pallas-stitch"])
    out = capsys.readouterr().out
    assert "async, in-flight high water" in out
    assert _summary(out)[4] == 0


@pytest.mark.parametrize("flag,item", [
    (["--workers", "2"], 10), (["--shards", "2"], 11),
    (["--parallel"], 11), (["--online-latency"], 10),
    (["--model", "tangram"], 10), (["--model-map", "0.5=tangram"], 10),
    (["--placement", "round"], 10), (["--planner", "cost"], 11)])
def test_unported_options_name_their_roadmap_item(flag, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1, item {item} "):
        tserve.main(["--device", "cpu", "--frames", "2"] + flag)


def test_serve_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--frames", "2", "--canvas", "64"])
