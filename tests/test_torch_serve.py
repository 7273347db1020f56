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


SHARD_ARGS = ["--frames", "16", "--canvas", "128", "--slo", "5.0",
              "--cameras", "3"]


def _shard_rows(out: str):
    return re.findall(r"  shard (\d+): (\d+) arrivals, (\d+) invocations, "
                      r"(\d+) violations, backlog high water (\d+)", out)


@pytest.fixture
def pinned_tables(monkeypatch):
    """One fixed latency table for every profile and a step clock on every
    executor, in both drivers, so neither the boundaries nor the shard
    rows (violations, backlog high water) follow this host's timing."""
    from repro.core.latency import LatencyTable as JTable
    monkeypatch.setattr(jserve, "measure",
                        lambda *a, **k: JTable(dict(TABLE)))
    monkeypatch.setattr(tserve, "profile",
                        lambda *a, **k: LatencyTable(dict(TABLE)))
    for mod in (jserve, tserve):
        make = mod.make_executor
        monkeypatch.setattr(
            mod, "make_executor",
            lambda name, _make=make, **cfg: _make(name, clock=_step_clock(),
                                                  **cfg))


@pytest.mark.parametrize("fuse", [[], ["--fuse"]])
@pytest.mark.parametrize("flags", [
    ["--shards", "2"], ["--shards", "2", "--parallel"],
    ["--shards", "2", "--planner", "equal"]])
def test_serve_cli_shards_match_jax_driver(flags, fuse, jax_weights,
                                           pinned_tables, capsys):
    """``--shards 2`` (sequential, ``--parallel``, ``--planner equal``),
    unfused and fused: N, M, D, the evidence MB, 0 frames held, the
    ``N shard(s), <planner> planner[, parallel]`` text and both ``shard
    i:`` rows equal the JAX driver's on its weights.  The trace source
    has no camera rates, so cameras 0 and 2 go to shard 0, camera 1 to
    shard 1, whatever the planner."""
    args = SHARD_ARGS + flags + fuse
    jserve.main(args)
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu"] + args)
    got = capsys.readouterr().out
    _assert_same_summary(_summary(got), _summary(want))
    mode = re.search(r"\((\d shard\(s\), \w+ planner(, parallel)?)", want)[1]
    assert f"({mode}," in got
    assert ("parallel" in mode) == ("--parallel" in flags)
    rows = _shard_rows(got)
    assert rows == _shard_rows(want) and len(rows) == 2
    assert sum(int(r[1]) for r in rows) == _summary(got)[0] > 0
    assert sum(int(r[2]) for r in rows) == _summary(got)[1]
    assert (", fused" in got) == bool(fuse)


def test_serve_cli_shards_validate_like_jax_driver(capsys):
    for bad in (["--shards", "0"], ["--parallel"],
                ["--shards", "2", "--workers", "2"]):
        for main in (jserve.main, tserve.main):
            with pytest.raises(SystemExit):
                main(["--frames", "2"] + bad)
        err = capsys.readouterr().err
        assert err.count("error:") == 2


def test_serve_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--frames", "2", "--canvas", "64"])


# ------------------------------------------ models, pools, online tables ----

MODEL_ARGS = ["--frames", "16", "--canvas", "128", "--slo", "0.5,2.0",
              "--model-map", "0.5=vit_s16", "--model-map", "2.0=tangram"]


class _JaxBuilt:
    """A port registry spec whose ``build`` returns the JAX registry
    build's weights (``jax.random`` seeded by the model's name) through
    ``convert_params``."""

    def __init__(self, name):
        from repro_torch.core.models import make_model
        self.name, self.spec = name, make_model(name)

    def __getattr__(self, attr):
        return getattr(self.spec, attr)

    def build(self, canvas=None, reduced=True, device=None):
        from repro.core.models import make_model as jmake_model
        cfg, params, _, _ = jmake_model(self.name).build(canvas=canvas)
        tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(DetectorConfig)})
        tparams = tdet.convert_params(
            jax.tree_util.tree_map(np.asarray, params), tcfg,
            torch.device("cpu"))
        return tcfg, tparams, tdet.serve_fn(tcfg)


def _step_clock(step=0.05):
    """An executor clock that advances ``step`` a reading: an invocation's
    measured wall time depends on the order of the executor's calls
    alone, which both drivers share."""
    calls = iter(range(1 << 30))
    return lambda: next(calls) * step


@pytest.fixture
def pinned_drivers(monkeypatch, pinned_tables):
    """Both drivers on the JAX registry builds' weights, one fixed latency
    table for every profile, and step clocks on every executor, so
    invocation boundaries (online tables included) cannot depend on this
    host's timing."""
    monkeypatch.setattr(tserve, "make_model", _JaxBuilt)


@pytest.mark.parametrize("extra", [
    [], ["--async-device"], ["--online-latency"],
    ["--online-latency", "--async-device"],
    ["--workers", "2", "--placement", "model"],
    ["--workers", "2", "--placement", "model", "--online-latency"],
    ["--workers", "2", "--placement", "affinity", "--fuse"],
    ["--fuse", "--online-latency"]])
def test_serve_cli_models_pools_online_match_jax_driver(extra,
                                                        pinned_drivers,
                                                        capsys):
    """``--model-map`` over two registry models, ``--workers 2`` and
    ``--online-latency``: N, M, D, the evidence MB and 0 frames held equal
    the JAX driver's, and so do the patches each model served.  Which
    worker takes an invocation follows the least-outstanding count, so
    each executor's readiness probe (JAX arrays may still be computing on
    the CPU; the port's CPU tensors are ready at once); the per-worker
    rows, weight-cache hits and violations are not compared."""
    jserve.main(MODEL_ARGS + extra)
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu"] + MODEL_ARGS + extra)
    got = capsys.readouterr().out
    _assert_same_summary(_summary(got), _summary(want))
    assert _summary(got)[0] > 0 and _summary(got)[2] > 0
    for out in (want, got):
        assert "models: tangram, vit_s16 (default tangram)" in out

    def rows(out, prefix):
        return [re.match(r"  \w+ \S+: \d+ \w+", line)[0]
                for line in out.splitlines() if line.startswith(prefix)]
    assert rows(got, "  model ") == rows(want, "  model ")
    assert len(rows(got, "  model ")) == 2
    workers = [int(n) for n in re.findall(r"  worker \d+: (\d+) invoc", got)]
    assert sum(workers) == _summary(got)[1]
    if "--workers" in extra:
        assert "2 worker(s)" in got and len(workers) == 2
    assert (", online latency" in got) == ("--online-latency" in extra)


def test_serve_cli_quantize_maps_models_to_int8(monkeypatch, capsys):
    """``--quantize`` with models serves their registered ``_int8``
    variants (``vit_s16_int8``; ``efficientnet_b7`` has none)."""
    tserve.main(["--device", "cpu", "--quantize", "--frames", "16",
                 "--canvas", "128", "--slo", "0.5,2.0", "--model-map",
                 "0.5=vit_s16", "--model-map", "2.0=efficientnet_b7"])
    out = capsys.readouterr().out
    assert "models: efficientnet_b7, vit_s16_int8" in out
    assert ", int8" in out and _summary(out)[4] == 0
    assert "  model vit_s16_int8:" in out


def test_fused_model_runtimes_match_jax_unfused_engine(detector):
    """``DeviceExecutor(models=, fuse=True)``: two registry models' fused
    runtimes (K4/K3 plain versions) route what the JAX engine's unfused
    executor routes with the same models, on one two-class trace."""
    from repro.core.engine import InvokerPool as JInvokerPool
    from repro.core.engine import ModelRuntime as JModelRuntime
    from repro.core.engine import slo_class as jslo_class
    from repro.core.invoker import SLOAwareInvoker as JSLOAwareInvoker
    from repro.core.models import make_model as jmake_model
    from repro_torch.core.engine import (DeviceExecutor, InvokerPool,
                                         ModelRuntime, slo_class)
    from repro_torch.core.invoker import SLOAwareInvoker

    names = {0.3: "vit_s16", 5.0: "efficientnet_b7"}
    frames, arrivals = {}, []
    for i, slo in enumerate(sorted(names)):
        src = jmake_source("synthetic", n_frames=16, canvas=CANVAS, slo=slo,
                           scene=i, camera_id=i,
                           frame_sink=lambda f, px, n:
                           frames.__setitem__(f, (px, n)))
        arrivals.extend(src.events(None))
    arrivals.sort(key=lambda a: a.t_arrive)
    jruntimes, truntimes = {}, {}
    for name in names.values():
        cfg, params, serve_fn, _ = jmake_model(name).build(canvas=CANVAS)
        jruntimes[name] = JModelRuntime(serve_fn, params, CANVAS, CANVAS)
        tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(DetectorConfig)})
        tparams = tdet.convert_params(
            jax.tree_util.tree_map(np.asarray, params), tcfg,
            torch.device("cpu"))
        truntimes[name] = ModelRuntime(
            tdet.serve_fn(tcfg), tparams, CANVAS, CANVAS,
            **tserve.fused_fields(tcfg, tparams))
    jparams, jfn, _, _ = detector[0]
    tparams, tfn, tcfg = detector[1]
    jex = JDeviceExecutor(jfn, jparams, CANVAS, CANVAS, clock=lambda: 0.0,
                          models=jruntimes)
    tex = DeviceExecutor(tfn, tparams, CANVAS, CANVAS, device="cpu",
                         clock=lambda: 0.0, models=truntimes,
                         **tserve.fused_kwargs(tcfg, tparams))
    results = []
    for ex, pool_cls, inv_cls, table_cls, cls_fn, engine_cls, patch_cls, \
            arr_cls in (
            (jex, JInvokerPool, JSLOAwareInvoker, JLatencyTable, jslo_class,
             JServingEngine, None, None),
            (tex, InvokerPool, SLOAwareInvoker, LatencyTable, slo_class,
             ServingEngine, Patch, Arrival)):
        routed, pixels = _capture(ex)
        for fid, (px, n) in frames.items():
            ex.add_frame(fid, px, n)
        pool = pool_cls(lambda key, _i=inv_cls, _t=table_cls:
                        _i(CANVAS, CANVAS, _t(dict(TABLE)), 4),
                        classify=cls_fn, model_of=names.get)
        engine = engine_cls(pool, ex)
        engine.run(arrivals if patch_cls is None else
                   [arr_cls(a.t_arrive,
                            patch_cls(**dataclasses.asdict(a.patch)),
                            a.n_bytes) for a in arrivals])
        results.append(_result(engine, ex, routed, pixels))
        results[-1]["models"] = sorted({inv.model
                                        for inv in engine.invocations})
    want, got = results
    assert got["fused"] == len(got["bounds"]) >= 2 and want["fused"] == 0
    assert got["models"] == want["models"] == sorted(names.values())
    assert sum(len(v) for v in want["routed"].values()) > 0
    _assert_same(got, want)


def test_fused_executor_refuses_a_model_without_fused_fields():
    """Every fused runtime needs the fused fields: an eager entry raises
    at construction, a lazy one when it is first built."""
    from repro_torch.core.engine import DeviceExecutor, ModelRuntime
    cfg, params, fn = tserve.build_detector(CANVAS, device="cpu")
    bare = ModelRuntime(fn, params, CANVAS, CANVAS)
    with pytest.raises(ValueError, match="model 'plain' is missing"):
        DeviceExecutor(fn, params, CANVAS, CANVAS, device="cpu",
                       models={"plain": bare},
                       **tserve.fused_kwargs(cfg, params))
    ex = DeviceExecutor(fn, params, CANVAS, CANVAS, device="cpu",
                        models={"lazy": lambda: bare},
                        **tserve.fused_kwargs(cfg, params))
    with pytest.raises(ValueError, match="model 'lazy' is missing"):
        ex._runtime("lazy")
    assert ex._runtime("unmapped") is ex.runtime
    with pytest.raises(ValueError, match="default runtime is missing"):
        DeviceExecutor(fn, params, CANVAS, CANVAS, device="cpu", fuse=True)


# ------------------------------------------- the data-parallel canvas batch ----

def _lines(out: str, prefix: str, violations: bool = True):
    """The lines starting with ``prefix``, wall time blanked (and the SLO
    violations, which follow each host's timing, unless ``violations``)."""
    lines = [re.sub(r"[\d.]+s wall", "-s wall", line)
             for line in out.splitlines() if line.startswith(prefix)]
    if not violations:
        lines = [re.sub(r"\d+ SLO violations", "- SLO violations", line)
                 for line in lines]
    return lines


@pytest.mark.parametrize("fuse", [[], ["--fuse"]])
def test_serve_cli_mesh_and_summary_lines_equal_jax_driver(
        fuse, jax_weights, pinned_tables, capsys):
    """On one device the ``serve mesh:`` line and the whole summary line,
    ``0 data-parallel over data=1`` included, equal the JAX driver's
    apart from wall time (pinned tables and step clocks fix the
    violations too)."""
    args = ["--frames", "16", "--canvas", "128", "--slo", "5.0"] + fuse
    jserve.main(args)
    want = capsys.readouterr().out
    tserve.main(["--device", "cpu"] + args)
    got = capsys.readouterr().out
    for prefix in ("serve mesh:", "served "):
        assert _lines(got, prefix) == _lines(want, prefix), prefix
    assert "0 data-parallel over data=1)" in _lines(got, "served ")[0]
    assert "serve mesh: 1 worker(s) x data=1 model=1 (1 devices each)" in got


def _perturbed(params):
    """The JAX driver's weights moved by a seeded normal (0.3), so that
    its detector routes detections (the raw init routes none)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_unflatten(tree, [
        x + jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
        for x in leaves])


_PERTURBED_DRIVER = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch import serve
build = serve.build_detector


def perturbed(params):
{body}


def build_perturbed(canvas=256, quantize=False):
    cfg, params, fn, rules = build(canvas, quantize=quantize)
    return cfg, perturbed(params), fn, rules


serve.build_detector = build_perturbed
serve.main(sys.argv[1:])
"""


def _jax_driver_on_8_devices(args):
    """The JAX driver on eight fake host devices, in a subprocess (jax
    fixes its device count at start), serving :func:`_perturbed`
    weights."""
    import inspect
    import os
    import subprocess
    import sys
    body = inspect.getsource(_perturbed).split('"""')[-1]
    code = _PERTURBED_DRIVER.format(body=body.rstrip())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, "-c", code, *args],
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture
def perturbed_weights(monkeypatch):
    """The port's driver serves :func:`_perturbed` JAX driver weights."""
    def build(canvas=256, quantize=False, device=None):
        cfg, params, _, _ = jserve.build_detector(canvas, quantize=quantize)
        tcfg = DetectorConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(DetectorConfig)})
        tparams = tdet.convert_params(
            jax.tree_util.tree_map(np.asarray, _perturbed(params)), tcfg,
            torch.device("cpu"))
        return tcfg, tparams, tdet.serve_fn(tcfg)
    monkeypatch.setattr(tserve, "build_detector", build)


def test_serve_cli_data_parallel_on_8_devices_equals_jax_driver(
        perturbed_weights, capsys):
    """The port on eight CPU devices (in process) against the JAX driver
    on eight fake host devices (a subprocess), on the JAX driver's
    weights: the ``serve mesh:`` and summary lines equal apart from wall
    time and SLO violations (the JAX subprocess's own timing, its
    compiles included, decides those); every invocation split its batch
    over data=8; patches and detections equal the one-device run's
    (sharding changes no result).  SLO 120 s: batching follows the memory
    bound and the final flush alone, never this host's timing."""
    args = ["--frames", "16", "--canvas", "128", "--slo", "120"]
    want = _jax_driver_on_8_devices(args)
    tserve.main(["--device", "cpu"] + args,
                devices=[torch.device("cpu")] * 8)
    got = capsys.readouterr().out
    for prefix in ("serve mesh:", "served "):
        assert _lines(got, prefix, violations=False) == \
            _lines(want, prefix, violations=False), prefix
    assert "serve mesh: 1 worker(s) x data=8" in got
    served = _lines(got, "served ")[0]
    assert "data-parallel over data=8" in served
    assert "(0 data-parallel" not in served
    tserve.main(["--device", "cpu"] + args)
    one = capsys.readouterr().out
    assert _summary(one)[:3:2] == _summary(got)[:3:2]
    assert _summary(got)[0] > 0 and _summary(got)[2] > 0


def test_serve_cli_worker_pool_slices_8_devices_like_jax_driver(
        perturbed_weights, capsys):
    """``--workers 2`` over eight CPU devices: two data=4 slices, every
    patch served data-parallel within its slice, the pool's shared frame
    store drained; the JAX driver on eight fake devices prints the same
    mesh line."""
    args = ["--frames", "16", "--canvas", "128", "--slo", "120",
            "--workers", "2", "--placement", "least", "--online-latency"]
    want = _jax_driver_on_8_devices(args)
    tserve.main(["--device", "cpu"] + args,
                devices=[torch.device("cpu")] * 8)
    got = capsys.readouterr().out
    assert _lines(got, "serve mesh:") == _lines(want, "serve mesh:")
    assert "serve mesh: 2 worker(s) x data=4" in got
    served = _lines(got, "served ")[0]
    assert "data-parallel over data=4" in served
    assert "(0 data-parallel" not in served
    assert "0 frames still held" in served
    assert _summary(got)[:3:2] == _summary(want)[:3:2]
    workers = [line for line in got.splitlines()
               if line.strip().startswith("worker ")]
    assert len(workers) == 2 and all("drift" in w for w in workers)


def test_shard_canvases_pads_splits_and_serves_like_one_device():
    """``shard_canvases`` pads the batch to a multiple of data with zero
    canvases and splits it a chunk a device; ``serve_sharded`` on the
    chunks equals ``serve_fn`` on the whole batch, pad rows dropped."""
    from repro_torch.core.engine import ModelRuntime, shard_canvases
    from repro_torch.launch.mesh import make_serve_mesh
    cfg = DetectorConfig(name="d", canvas=64, patch=32, n_layers=1,
                         d_model=16, n_heads=2, d_ff=32,
                         param_dtype="float32", compute_dtype="float32")
    params = tdet.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    fn = tdet.serve_fn(cfg)
    x = torch.rand(3, 64, 64, 3)
    mesh = make_serve_mesh(devices=[torch.device("cpu")] * 4)
    chunks, sharded = shard_canvases(x, mesh)
    assert sharded and [tuple(c.shape) for c in chunks] == [(1, 64, 64, 3)] * 4
    assert torch.equal(torch.cat(chunks)[:3], x)
    assert not torch.cat(chunks)[3:].any()
    rt = ModelRuntime(fn, params, 64, 64, mesh=mesh)
    assert len(rt.replicas) == 4 and rt.replicas[1] is rt.replicas[0]
    obj, boxes = rt.serve_sharded(chunks, 3, torch.device("cpu"))
    want_obj, want_boxes = fn(params, x)
    torch.testing.assert_close(obj, want_obj, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(boxes, want_boxes, rtol=1e-5, atol=1e-4)
    one = make_serve_mesh(devices=[torch.device("cpu")])
    chunks, sharded = shard_canvases(x, one)
    assert not sharded and len(chunks) == 1 and chunks[0] is x
    assert ModelRuntime(fn, params, 64, 64, mesh=one).replicas[0] is not \
        params
