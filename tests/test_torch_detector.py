"""The detector: the port's forward / decode on parameters converted from
the JAX package's tree, against the JAX detector on the same canvases.

Tolerances: 1e-4 in float32 (summation order differs between XLA and
PyTorch's CPU matmuls); 2e-2 in bfloat16 (the two frameworks round
intermediate products to bf16 at different places)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as param_lib
from repro.config import DetectorConfig as JDetectorConfig
from repro.models import detector as jdet
from repro.sharding import ShardingConfig
from repro_torch.config import DetectorConfig
from repro_torch.models import detector as tdet

CPU = torch.device("cpu")
DIMS = dict(name="det", canvas=128, patch=32, n_layers=2, d_model=64,
            n_heads=4, d_ff=128)


def _pair(dtype):
    jcfg = JDetectorConfig(**DIMS, param_dtype=dtype, compute_dtype=dtype)
    tcfg = DetectorConfig(**DIMS, param_dtype=dtype, compute_dtype=dtype)
    jparams = param_lib.init_params(jax.random.PRNGKey(0),
                                    jdet.param_specs(jcfg))
    # perturb the zero/one inits so biases and norm affines are exercised
    leaves, tree = jax.tree_util.tree_flatten(jparams)
    rng = np.random.default_rng(0)
    leaves = [x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
              for x in leaves]
    jparams = jax.tree_util.tree_unflatten(tree, leaves)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tdet.convert_params(np_tree, tcfg, CPU)


def _canvases(b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, 128, 128, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_raw_head_and_decode_match_jax(dtype, tol):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    x = _canvases()
    rules = ShardingConfig.make().rules
    want = np.array(jdet.forward(jcfg, jparams, jnp.asarray(x), rules),
                    np.float32)
    got = tdet.forward(tcfg, tparams, torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 5)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)

    jobj, jboxes = jdet.decode_boxes(jcfg, jnp.asarray(want))
    tobj, tboxes = tdet.decode_boxes(tcfg, torch.from_numpy(want))
    np.testing.assert_allclose(tobj.numpy(), np.asarray(jobj), atol=1e-6)
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes),
                               atol=1e-4, rtol=1e-6)

    jo, jb = jdet.serve(jcfg, jparams, jnp.asarray(x), rules)
    to, tb = tdet.serve_fn(tcfg)(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=tol)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                               atol=tol * 128, rtol=tol)


def test_convert_params_unstacks_layers():
    jcfg, tcfg, jparams, tparams = _pair("float32")
    layers = tparams["trunk"]["layers"]
    assert len(layers) == tcfg.n_layers
    for i, lp in enumerate(layers):
        np.testing.assert_array_equal(
            lp["attn"]["wq"].numpy(),
            np.asarray(jparams["trunk"]["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            lp["mlp"]["fc2"]["bias"].numpy(),
            np.asarray(jparams["trunk"]["layers"]["mlp"]["fc2"]["bias"][i]))
    # unstacked (scan_layers=False style) trees convert the same way
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    stacked = np_tree["trunk"].pop("layers")
    for i in range(tcfg.n_layers):
        np_tree["trunk"][f"layer_{i}"] = jax.tree_util.tree_map(
            lambda a: a[i], stacked)
    again = tdet.convert_params(np_tree, tcfg, CPU)
    assert torch.equal(again["trunk"]["layers"][1]["ln2"]["scale"],
                       layers[1]["ln2"]["scale"])


def test_convert_params_refuses_a_trunk_without_layers():
    jcfg, tcfg, jparams, _ = _pair("float32")
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    np_tree["trunk"].pop("layers")
    with pytest.raises(KeyError, match="neither trunk.layers nor"):
        tdet.convert_params(np_tree, tcfg, CPU)


def test_bf16_convert_keeps_bits():
    jcfg, tcfg, jparams, tparams = _pair("bfloat16")
    pe = tparams["trunk"]["patch_embed"]["kernel"]
    assert pe.dtype == torch.bfloat16
    ref = np.asarray(jparams["trunk"]["patch_embed"]["kernel"])
    np.testing.assert_array_equal(pe.view(torch.int16).numpy(),
                                  ref.view(np.int16))


def test_init_params_matches_reference_shapes_and_scales():
    jcfg, tcfg, jparams, _ = _pair("float32")
    gen = torch.Generator().manual_seed(3)
    tparams = tdet.init_params(tcfg, gen, CPU)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    converted = tdet.convert_params(np_tree, tcfg, CPU)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    want = jax.tree_util.tree_map(lambda t: tuple(t.shape), converted)
    assert got == want
    # the reference's init rules: 1/sqrt(fan_in) normals, 0.02 positions
    fc1 = tparams["trunk"]["layers"][0]["mlp"]["fc1"]["kernel"]
    assert abs(float(fc1.std()) - 1 / np.sqrt(64)) < 0.02
    wo = tparams["trunk"]["layers"][0]["attn"]["wo"]
    assert abs(float(wo.std()) - 1 / np.sqrt(64)) < 0.02
    assert abs(float(tparams["trunk"]["pos_embed"].std()) - 0.02) < 0.005
    assert not tparams["det_head"]["bias"].any()
    assert torch.equal(tparams["trunk"]["ln_f"]["scale"], torch.ones(64))
    # a seed gives the same weights every time
    again = tdet.init_params(tcfg, torch.Generator().manual_seed(3), CPU)
    assert torch.equal(again["trunk"]["patch_embed"]["kernel"],
                       tparams["trunk"]["patch_embed"]["kernel"])


def test_full_width_config_matches_reference():
    from repro.configs import tangram_detector as jarch
    from repro_torch.configs import tangram_detector as tarch
    j, t = dataclasses.asdict(jarch.ARCH), dataclasses.asdict(tarch.ARCH)
    for key in ("canvas", "patch", "n_layers", "d_model", "n_heads", "d_ff",
                "param_dtype", "compute_dtype"):
        assert t[key] == j[key], key
    assert tarch.ARCH.n_params == jarch.ARCH.n_params
