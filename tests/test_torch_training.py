"""The training substrate of the port against the JAX package's: the AdamW
schedule, norm and update, the train step with and without gradient
accumulation, checkpoints (each package restores the other's), failure
drills, the host data loaders, a JAX run continued in the port, and the
training driver with a drill.

Tolerances (float32): losses and the learning rate within 1e-5 relative;
parameters, moments and gradients within 1e-5 of each leaf's max-abs
after one step (the two frameworks sum in other orders); bfloat16
parameters within one bf16 ulp (an update rounds to bf16 from float32
values that may differ in their last bits).  The loaders are bit-equal."""
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.config import DetectorConfig as JDetectorConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.data import loader as jloader
from repro.launch import train as jtrain
from repro.models import detector as jdet
from repro.sharding import ShardingConfig
from repro.training import checkpoint as jckpt
from repro.training import elastic as jelastic
from repro.training import optimizer as jopt
from repro.training.train_state import make_train_step as jmake_step
from repro_torch import configs
from repro_torch.config import DetectorConfig, ShapeConfig
from repro_torch.configs import tangram_detector
from repro_torch.data import loader as tloader
from repro_torch.launch import train as ttrain
from repro_torch.models import detector as tdet
from repro_torch.param import sorted_leaves
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import elastic as telastic
from repro_torch.training import optimizer as topt
from repro_torch.training.train_state import make_train_step as tmake_step

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
RTOL = 1e-5
OPT = dict(lr=0.05, warmup_steps=3, total_steps=20, weight_decay=0.1,
           clip_norm=1.0)


def to_torch(tree):
    """A JAX tree (or numpy) as float tensors, keeping bf16 bits."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(leaf, tree)


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def hold_tree(got, want, tol=RTOL):
    """Leaf by leaf (``want`` a JAX tree of the same structure): within
    ``tol`` of the leaf's max-abs; bf16 within one bf16 ulp."""
    got, want = sorted_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_max_ulp(
                to_numpy(g).astype(np.float32), w.astype(np.float32),
                maxulp=1 << 16)         # one bf16 ulp in float32's units
            continue
        g = to_numpy(g)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


def quad_loss_j(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean(jnp.square(pred - batch["y"]))


def quad_loss_t(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean(torch.square(pred - batch["y"]))


def toy(seed=0, n=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(4, 2)) * 0.1).astype(dtype),
              "b": (rng.normal(size=(2,)) * 0.1).astype(dtype)}
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w_true = np.array([[1., 0.], [0., 2.], [3., 0.], [0., -1.]], np.float32)
    return params, {"x": x, "y": x @ w_true + 0.5}


# ------------------------------------------------------------ optimizer ----

def test_lr_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1), dict(lr=3e-4, warmup_steps=0,
                                            total_steps=7)):
        jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
        steps = np.arange(0, kw["total_steps"] + 3, dtype=np.int32)
        want = np.array([float(jopt.lr_schedule(jc, jnp.asarray(s)))
                         for s in steps])
        got = topt.lr_schedule(tc, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "z": [rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
                  rng.normal(size=(2, 2)).astype(np.float32)]}
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(topt.global_norm(to_torch(tree)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_update_matches_jax(dtype):
    """Three steps in from nonzero moments, with clipping active."""
    params, _ = toy(2, dtype=dtype)
    rng = np.random.default_rng(3)
    grads = {k: (rng.normal(size=v.shape) * 2).astype(dtype)
             for k, v in params.items()}
    state = {"m": {k: rng.normal(size=v.shape).astype(np.float32) * 0.1
                   for k, v in params.items()},
             "v": {k: rng.uniform(size=v.shape).astype(np.float32) * 0.1
                   for k, v in params.items()},
             "count": np.int32(3)}
    jc, tc = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    jp, js, jm = jopt.update(jc, *(jax.tree_util.tree_map(jnp.asarray, t)
                                   for t in (grads, state, params)))
    tstate = dict(to_torch({"m": state["m"], "v": state["v"]}),
                  count=torch.tensor(3, dtype=torch.int32))
    tp, ts, tm = topt.update(tc, to_torch(grads), tstate, to_torch(params))
    assert float(jm["grad_norm"]) > OPT["clip_norm"]
    hold_tree(tp, jp)
    hold_tree({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 4
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=RTOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    params, batch = toy(4)
    jc, tc = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = to_torch(params)
    ts = topt.init(tp)
    jstep = jax.jit(jmake_step(quad_loss_j, jc, accum_steps=accum))
    tstep = tmake_step(quad_loss_t, tc, accum_steps=accum)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=RTOL)
    hold_tree(tp, jp)
    hold_tree({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})


def test_grad_accumulation_equals_full_batch():
    params, batch = toy(5)
    tc = topt.OptimizerConfig(lr=0.01, warmup_steps=0, total_steps=10,
                              weight_decay=0.0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = [tmake_step(quad_loss_t, tc, accum_steps=a)(
        to_torch(params), topt.init(to_torch(params)), tb) for a in (1, 4)]
    np.testing.assert_allclose(float(out[0][2]["loss"]),
                               float(out[1][2]["loss"]), rtol=1e-6)
    for a, b in zip(sorted_leaves(out[0][0]), sorted_leaves(out[1][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="accum_steps"):
        tmake_step(quad_loss_t, tc, accum_steps=3)(
            to_torch(params), topt.init(to_torch(params)), tb)


# ----------------------------------------------------------- checkpoint ----

def test_checkpoint_atomic_commit_and_keep_k():
    tree = {"a": torch.arange(4.0)}
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30, 40):
            tckpt.save(d, s, tree, keep=2)
        assert tckpt.committed_steps(d) == [30, 40]
        assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_checkpoint_roundtrip_keeps_dtypes():
    tree = {"w": torch.ones((3, 3), dtype=torch.bfloat16),
            "opt": {"m": torch.zeros(5), "count": torch.tensor(
                7, dtype=torch.int32)},
            "layers": [{"k": torch.randn(2)}, {"k": torch.randn(2)}]}
    with tempfile.TemporaryDirectory() as d:
        assert tckpt.restore_latest(d, tree) == (None, None)
        tckpt.save(d, 7, tree)
        restored, step = tckpt.restore_latest(d, tree)
        assert step == 7
        for got, want in zip(sorted_leaves(restored), sorted_leaves(tree)):
            assert got.dtype == want.dtype and torch.equal(got, want)
        restored = tckpt.restore(d, 7, tree, device="cpu")
        assert restored["w"].device == CPU


def test_checkpoint_torn_write_ignored():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.arange(4.0)})
        os.makedirs(os.path.join(d, "step_00000002.tmp"))
        assert tckpt.latest_step(d) == 1


def test_checkpoint_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.zeros((2, 2))})
        with pytest.raises(ValueError, match="leaf 0"):
            tckpt.restore(d, 1, {"a": torch.zeros((3, 3))})
        with pytest.raises(ValueError, match="structure"):
            tckpt.restore(d, 1, {"a": torch.zeros((2, 2)),
                                 "b": torch.zeros(1)})


def _train_state(dtype):
    """The toy tree and its optimizer state after two steps (JAX)."""
    params, batch = toy(6, dtype=dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    step = jax.jit(jmake_step(quad_loss_j, jopt.OptimizerConfig(**OPT)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jp, js, _ = step(jp, js, jb)
    return {"p": jp, "o": js}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_checkpoints_cross_packages(dtype):
    """A checkpoint of the toy tree and its optimizer state written by the
    JAX package restores in the port, and the port's in the JAX package,
    bit for bit."""
    jtree = _train_state(dtype)
    like = {"p": to_torch(jtree["p"]),
            "o": {"m": to_torch(jtree["o"]["m"]),
                  "v": to_torch(jtree["o"]["v"]),
                  "count": torch.tensor(0, dtype=torch.int32)}}
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(os.path.join(d, "jax"), 2, jtree)
        got, step = tckpt.restore_latest(os.path.join(d, "jax"), like)
        assert step == 2
        for g, w in zip(sorted_leaves(got), jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
            assert to_numpy(g).dtype == np.asarray(w).dtype
        tckpt.save(os.path.join(d, "port"), 2, got)
        back, step = jckpt.restore_latest(os.path.join(d, "port"), zeros)
        assert step == 2
        for g, w in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jtree)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------- elastic ----

def test_failure_injector_and_rescale_batch():
    inj = telastic.FailureInjector([telastic.FailureEvent(5, "chip", 1),
                                    telastic.FailureEvent(2, "host", 0)])
    assert inj.poll(4) == []
    assert [e.kind for e in inj.poll(5)] == ["chip"]
    assert inj.poll(5) == []
    assert [e.step for e in inj.events] == [2]
    for args in ((256, 16, 12), (256, 16, 8), (33, 4, 3)):
        assert telastic.rescale_batch(*args) == jelastic.rescale_batch(*args)


# --------------------------------------------------------------- loaders ----

@pytest.mark.parametrize("seed", [0, 1])
def test_loaders_bit_equal_jax(seed):
    for jb, tb in zip(jloader.detector_batches(128, 3, seed=seed,
                                               n_batches=2),
                      tloader.detector_batches(128, 3, seed=seed,
                                               n_batches=2)):
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
        assert tb["valid"].any()
    for jb, tb in zip(jloader.lm_batches(512, 2, 64, seed=seed, n_batches=3),
                      tloader.lm_batches(512, 2, 64, seed=seed, n_batches=3)):
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_shapes_and_train_c32():
    (shape,) = [s for s in tangram_detector.SHAPES if s.name == "train_c32"]
    assert (shape.kind, shape.img_res, shape.global_batch, shape.is_train,
            shape.is_decode) == ("train", 1024, 32, True, False)
    from repro.configs import get as jget
    assert [(s.name, s.kind, s.img_res, s.global_batch)
            for s in tangram_detector.SHAPES] == [
        (s.name, s.kind, s.img_res, s.global_batch)
        for s in jget("tangram-detector").shapes]
    cfg = configs.get("tangram-detector")
    assert cfg.remat is False
    jcfg = jtrain.reduced_config(jget("tangram-detector").model)
    assert ttrain.reduced_config(cfg) == DetectorConfig(**{
        k: getattr(jcfg, k) for k in DetectorConfig.__dataclass_fields__
        if hasattr(jcfg, k)})


# ------------------------------------------------- carry across, driver ----

def test_jax_run_continued_in_the_port():
    """Three JAX train steps on the reduced detector; its parameters and
    optimizer state converted; one more step in each package."""
    from repro.configs import get as jget
    jcfg = jtrain.reduced_config(jget("tangram-detector").model)
    tcfg = ttrain.reduced_config(configs.get("tangram-detector"))
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jp = jparam.init_params(jax.random.PRNGKey(0), jdet.param_specs(jcfg))
    js = jopt.init(jp)
    jstep = jax.jit(jmake_step(
        lambda p, b: jdet.detection_loss(jcfg, p, b, RULES),
        jopt.OptimizerConfig(**opt_kw)))
    batches = list(jloader.detector_batches(jcfg.canvas, 2, n_batches=4))
    for b in batches[:3]:
        jp, js, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})

    def convert(tree, dtype=None):
        return tdet.convert_params(jax.tree_util.tree_map(np.asarray, tree),
                                   tcfg, CPU, dtype)

    tp = convert(jp)
    ts = topt.convert_state(jax.tree_util.tree_map(np.asarray, js),
                            lambda t: convert(t, torch.float32))
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32
    jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                for k, v in batches[3].items()})
    tstep = tmake_step(lambda p, b: tdet.detection_loss(tcfg, p, b),
                       topt.OptimizerConfig(**opt_kw))
    tp, ts, tm = tstep(tp, ts, ttrain.to_device(batches[3], CPU))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    for got, want in zip(sorted_leaves(tp), sorted_leaves(convert(jp))):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RTOL * scale
    for key in ("m", "v"):
        for got, want in zip(sorted_leaves(ts[key]),
                             sorted_leaves(convert(js[key], torch.float32))):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("drill", [6, 7])
def test_train_drill_matches_jax(monkeypatch, capsys, drill):
    """The port's ``train()`` and the JAX package's, from the same initial
    parameters (the JAX init, converted; checkpoints every 2 steps), with
    a drill that restores the latest checkpoint: the same losses.  At step
    6 the restored state is the one the run holds (the step-6
    checkpoint); at step 7 it drops step 6's update, so step 7 departs
    from a run without a drill while the steps before it do not."""
    dims = dict(name="drill", canvas=64, patch=32, n_layers=1, d_model=32,
                n_heads=2, d_ff=64, param_dtype="float32",
                compute_dtype="float32")
    jcfg, tcfg = JDetectorConfig(**dims), DetectorConfig(**dims)
    jinit = jparam.init_params(jax.random.PRNGKey(0), jdet.param_specs(jcfg))
    monkeypatch.setattr(ttrain, "init_params", lambda model, seed, device:
                        tdet.convert_params(jax.tree_util.tree_map(
                            np.asarray, jinit), tcfg, device))
    jshape = JShapeConfig("train", "train", img_res=64, global_batch=2)
    tshape = ShapeConfig("train", "train", img_res=64, global_batch=2)
    with tempfile.TemporaryDirectory() as d:
        kw = dict(steps=8, ckpt_every=2, log_every=100)
        _, jl = jtrain.train(jcfg, jshape, ckpt_dir=os.path.join(d, "j"),
                             injector=jelastic.FailureInjector(
                                 [jelastic.FailureEvent(drill, "host", 0)]),
                             **kw)
        _, tl = ttrain.train(tcfg, tshape, ckpt_dir=os.path.join(d, "t"),
                             injector=telastic.FailureInjector(
                                 [telastic.FailureEvent(drill, "host", 0)]),
                             device="cpu", **kw)
        assert f"[drill] host at step {drill}" in capsys.readouterr().out
        assert len(tl) == 8 and tckpt.latest_step(os.path.join(d, "t")) == 8
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        _, plain = ttrain.train(tcfg, tshape, ckpt_dir=None, device="cpu",
                                **kw)
    np.testing.assert_allclose(tl[:7], plain[:7], rtol=RTOL)
    assert (tl[7] == plain[7]) == (drill == 6)
