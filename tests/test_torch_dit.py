"""DiT: the port's ``models/dit.py`` against the JAX package's on
parameters converted from the JAX tree, on the same seeded latents,
timesteps and labels, at the reduced config (2 layers, d 64, 4 heads of
16, 8x8 latents, patch 2: 16 tokens, 16 classes).

adaLN-zero starts its modulation and output projections at zero, so a
freshly drawn DiT predicts eps = 0; every leaf here is moved by N(0, 0.05)
first, so that the attention, the MLP and the modulations all reach the
output.

Tolerances: 1e-4 in float32 (summation order differs between XLA and
PyTorch's CPU matmuls; the sampler's x0 estimate divides by sqrt(alpha)
down to 0.006, so its latents are compared relative to their scale);
2e-2 in bfloat16 (the frameworks round intermediate products to bf16 at
different places).  The DDIM timestep grid is compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.configs import get as jget
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import dit as jdit
from repro.sharding import ShardingConfig
from repro_torch import configs
from repro_torch.config import DiTConfig, dtype_of
from repro_torch.configs.reduced import reduce_arch
from repro_torch.models import dit as tdit
from repro_torch.param import ParamSpec, count_params

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DIT = ("dit-s2", "dit-xl2")


def _port_shapes(tree, path=()):
    """{path: (shape, dtype name, init)}, the layer list stacked."""
    if isinstance(tree, ParamSpec):
        return {path: (tree.shape, str(tree.dtype).split(".")[-1],
                       tree.init)}
    if isinstance(tree, list):
        return {p: ((len(tree),) + shape, dt, init) for p, (shape, dt, init)
                in _port_shapes(tree[0], path).items()}
    out = {}
    for k, v in tree.items():
        out.update(_port_shapes(v, path + (k,)))
    return out


def _jax_shapes(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jparam.ParamSpec))
    return {tuple(p.key for p in path): (tuple(s.shape),
                                         np.dtype(s.dtype).name, s.init)
            for path, s in leaves}


def _pair(dtype="float32", arch="dit-xl2"):
    jcfg = dataclasses.replace(jreduce(jget(arch).model), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(reduce_arch(configs.get(arch)),
                               param_dtype=dtype, compute_dtype=dtype)
    params = jparam.init_params(jax.random.PRNGKey(0),
                                jdit.param_specs(jcfg))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
              for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, leaves)
    tp = tdit.convert_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             CPU)
    return jcfg, tcfg, jp, tp


def _inputs(b=2, side=8, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, side, side, 4)).astype(np.float32)
    t = rng.integers(0, 1000, size=b).astype(np.int32)
    labels = np.array([3, 40][:b] + [0] * max(0, b - 2), np.int32)
    return z, t, labels


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", DIT)
def test_param_specs_equal_jax_at_full_width(arch):
    """Shapes, dtypes and init rules (the zero-init adaLN and output
    projections too) at the published widths; nothing is allocated."""
    cfg, jcfg = configs.get(arch), jget(arch).model
    assert _port_shapes(tdit.param_specs(cfg)) == _jax_shapes(
        jdit.param_specs(jcfg))


@pytest.mark.parametrize("arch", DIT)
def test_config_and_n_params_equal_jax(arch):
    cfg, jcfg = configs.get(arch), jget(arch).model
    for f in dataclasses.fields(DiTConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.n_params == jcfg.n_params
    assert cfg.n_active_params == jcfg.n_active_params
    assert cfg.d_ff == jcfg.d_ff
    for res in (None, 512, 1024):
        assert cfg.n_tokens(res) == jcfg.n_tokens(res)
    assert count_params(tdit.param_specs(cfg)) == jparam.count_params(
        jdit.param_specs(jcfg))
    assert reduce_arch(cfg) == DiTConfig(**{
        f.name: getattr(jreduce(jcfg), f.name)
        for f in dataclasses.fields(DiTConfig)})


def test_timestep_embedding_matches_jax():
    """float32 within 1e-4 over the whole timestep range (arguments up to
    999 radians, where the two libraries reduce them differently)."""
    t = np.array([0, 1, 17, 250, 500, 998, 999], np.int32)
    for dim in (256, 64):
        want = jdit.timestep_embedding(jnp.asarray(t), dim)
        got = tdit.timestep_embedding(torch.from_numpy(t), dim)
        assert got.dtype == torch.float32
        _close(got, want, 1e-4)


def test_patchify_round_trip_and_layout():
    z, _, _ = _inputs(b=3, side=8)
    got = tdit.patchify_latent(torch.from_numpy(z), 2)
    want = jdit.patchify_latent(jnp.asarray(z), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tdit.unpatchify_latent(got, 2, 4, 4),
                       torch.from_numpy(z))
    np.testing.assert_array_equal(
        tdit.unpatchify_latent(got, 2, 4, 4).numpy(),
        np.asarray(jdit.unpatchify_latent(want, 2, 4, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DIT)
def test_forward_matches_jax(arch, dtype):
    """The predicted noise within 1e-4 / 2e-2; labels past the classes
    clamp to the null class."""
    jcfg, tcfg, jp, tp = _pair(dtype, arch)
    z, t, labels = _inputs()
    labels[1] = 99
    want = jdit.forward(jcfg, jp, jnp.asarray(z), jnp.asarray(t),
                        jnp.asarray(labels), RULES)
    got = tdit.forward(tcfg, tp, torch.from_numpy(z), torch.from_numpy(t),
                       torch.from_numpy(labels))
    assert got.dtype == dtype_of(dtype)
    assert float(np.abs(np.asarray(want, np.float32)).max()) > 0.1
    _close(got, want, TOL[dtype])


def test_forward_flash_matches_jax_flash_interpret():
    """``impl="flash"`` (K6's plain version on the CPU) against the JAX
    Pallas kernel in interpret mode, float32 within 1e-4."""
    jcfg, tcfg, jp, tp = _pair()
    z, t, labels = _inputs(seed=2)
    want = jdit.forward(jcfg, jp, jnp.asarray(z), jnp.asarray(t),
                        jnp.asarray(labels), RULES, impl="flash_interpret")
    got = tdit.forward(tcfg, tp, torch.from_numpy(z), torch.from_numpy(t),
                       torch.from_numpy(labels), impl="flash")
    _close(got, want, 1e-4)


@pytest.mark.parametrize("n_steps", [2, 3, 4, 10, 50])
def test_ddim_timesteps_equal_jax(n_steps):
    """JAX's ``jnp.linspace(999, 0, n).astype(int32)`` exactly; at n = 4
    that is [999, 665, 332, 0], where ``torch.linspace`` truncates to
    [999, 666, 333, 0]."""
    want = np.asarray(jnp.linspace(jdit.T_MAX - 1, 0, n_steps).astype(
        jnp.int32)).tolist()
    assert tdit.ddim_timesteps(n_steps) == want
    if n_steps == 4:
        assert want == [999, 665, 332, 0]
        assert torch.linspace(999, 0, 4).to(torch.int32).tolist() != want


def test_ddim_timesteps_equal_jax_up_to_100_steps():
    for n in range(2, 101):
        assert tdit.ddim_timesteps(n) == np.asarray(jnp.linspace(
            jdit.T_MAX - 1, 0, n).astype(jnp.int32)).tolist(), n


def test_linear_alphas_match_jax():
    """float32 products of 1 - beta, within 2 float32 ulps of 1."""
    want = np.asarray(jdit.linear_alphas())
    got = tdit.linear_alphas()
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-7, rtol=0)


@pytest.mark.parametrize("impl,jimpl", [("xla", "xla"),
                                        ("flash", "flash_interpret")])
def test_ddim_sample_matches_jax(impl, jimpl):
    """Four steps (the gen_fast cell's count) from the same noise: the
    latents within 1e-4 of their scale."""
    jcfg, tcfg, jp, tp = _pair()
    z, _, labels = _inputs(seed=3)
    want = np.asarray(jdit.ddim_sample(jcfg, jp, jnp.asarray(z),
                                       jnp.asarray(labels), RULES,
                                       n_steps=4, impl=jimpl))
    got = tdit.ddim_sample(tcfg, tp, torch.from_numpy(z),
                           torch.from_numpy(labels), n_steps=4, impl=impl)
    assert got.dtype == torch.float32 and got.shape == z.shape
    scale = float(np.abs(want).max())
    assert np.isfinite(want).all() and scale > 1.0
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               atol=1e-4, rtol=0)


def test_diffusion_loss_matches_jax():
    jcfg, tcfg, jp, tp = _pair()
    z, t, labels = _inputs(seed=4)
    noise = np.random.default_rng(5).normal(size=z.shape).astype(np.float32)
    batch = {"latents": z, "t": t, "noise": noise, "labels": labels}
    want = jdit.diffusion_loss(jcfg, jp, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, RULES)
    got = tdit.diffusion_loss(tcfg, tp, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-4,
                               rtol=1e-4)


def test_fresh_model_predicts_zero_noise():
    """adaLN-zero: ``init_params`` leaves the modulations and the output
    projection at zero, so the prediction is 0, as the JAX init's is."""
    cfg = reduce_arch(configs.get("dit-s2"))
    p = tdit.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    z, t, labels = _inputs()
    out = tdit.forward(cfg, p, torch.from_numpy(z), torch.from_numpy(t),
                       torch.from_numpy(labels))
    assert not out.any() and not p["layers"][0]["ada"]["kernel"].any()


def test_bf16_convert_keeps_bits():
    jcfg, tcfg, jp, tp = _pair("bfloat16")
    got = tp["layers"][1]["ada"]["kernel"]
    want = np.asarray(jp["layers"]["ada"]["kernel"][1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
