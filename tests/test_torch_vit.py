"""The ViT / DeiT classifiers: the port's ``models/vit.py`` against the JAX
package's on parameters converted from the JAX tree, on the same seeded
images, at the reduced configs (2 layers, d 64, 4 heads of 16, 64^2
images, patch 16: 17 or 18 tokens).

Tolerances: 1e-4 in float32 (summation order differs between XLA and
PyTorch's CPU matmuls; the position resize is one bilinear pass); 2e-2 in
bfloat16 (the two frameworks round intermediate products to bf16 at
different places).  The K6 option (``impl="flash"``) runs K6's plain
version on the CPU and is held against the JAX Pallas kernel in
interpret mode (``impl="flash_interpret"``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.configs import get as jget
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import detector as jdet
from repro.models import vit as jvit
from repro.sharding import ShardingConfig
from repro_torch import configs
from repro_torch.config import DetectorConfig, ViTConfig, dtype_of
from repro_torch.configs.reduced import reduce_arch
from repro_torch.models import detector as tdet
from repro_torch.models import vit as tvit
from repro_torch.param import ParamSpec, count_params, map_tree

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VISION = ("vit-b16", "deit-b", "vit-s16")


def spec_shapes(tree, path=()):
    """A spec tree as {path: (shape, dtype name, init)}, the port's layer
    list stacked on a leading axis as the JAX tree stacks it."""
    if isinstance(tree, ParamSpec):
        return {path: (tree.shape, str(tree.dtype).split(".")[-1],
                       tree.init)}
    if isinstance(tree, list):
        return {p: ((len(tree),) + shape, dt, init) for p, (shape, dt, init)
                in spec_shapes(tree[0], path).items()}
    out = {}
    for k, v in tree.items():
        out.update(spec_shapes(v, path + (k,)))
    return out


def jax_spec_shapes(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jparam.ParamSpec))
    return {tuple(p.key for p in path): (tuple(s.shape),
                                         np.dtype(s.dtype).name, s.init)
            for path, s in leaves}


def jax_params(specs, seed=0):
    """The JAX package's init, every leaf then moved by N(0, 0.05) so that
    zero and one inits (biases, norms, tokens) are exercised."""
    params = jparam.init_params(jax.random.PRNGKey(seed), specs)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
              for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _pair(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jreduce(jget(arch).model), param_dtype=dtype,
                               compute_dtype=dtype, **over)
    tcfg = dataclasses.replace(reduce_arch(configs.get(arch)),
                               param_dtype=dtype, compute_dtype=dtype,
                               **over)
    jp = jax_params(jvit.param_specs(jcfg))
    tp = tvit.convert_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             CPU)
    return jcfg, tcfg, jp, tp


def _images(b, res, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, res, res, 3)).astype(np.float32)


def _close(got, want, tol):
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", VISION)
def test_param_specs_equal_jax_at_full_width(arch):
    """Every spec's shape (the port's layer list stacked), dtype and init
    rule equal the JAX package's at the published widths; nothing is
    allocated."""
    cfg, jcfg = configs.get(arch), jget(arch).model
    assert spec_shapes(tvit.param_specs(cfg)) == jax_spec_shapes(
        jvit.param_specs(jcfg))


@pytest.mark.parametrize("arch", VISION)
def test_n_params_equal_jax(arch):
    cfg, jcfg = configs.get(arch), jget(arch).model
    assert cfg.n_params == jcfg.n_params
    assert cfg.n_active_params == jcfg.n_active_params
    assert cfg.n_tokens == jcfg.n_tokens
    assert count_params(tvit.param_specs(cfg)) == jparam.count_params(
        jvit.param_specs(jcfg))


def test_arch_configs_equal_jax():
    for arch in VISION:
        cfg, jcfg = configs.get(arch), jget(arch).model
        for f in dataclasses.fields(ViTConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (arch, f)
        assert reduce_arch(cfg) == ViTConfig(**{
            f.name: getattr(jreduce(jcfg), f.name)
            for f in dataclasses.fields(ViTConfig)})


def test_detector_trunk_cfg_equals_jax():
    """``trunk_cfg`` is the JAX ``_trunk_cfg`` (a one-class head)."""
    for quant in (False, True):
        cfg = DetectorConfig(name="det", quant_weights=quant)
        j = jdet._trunk_cfg(jdet.DetectorConfig(name="det",
                                                quant_weights=quant))
        t = tdet.trunk_cfg(cfg)
        assert t == ViTConfig(**{f.name: getattr(j, f.name)
                                 for f in dataclasses.fields(ViTConfig)})
        assert t.n_classes == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_forward_matches_jax(arch, dtype):
    """Logits (and DeiT's two heads) within 1e-4 (f32) / 2e-2 (bf16)."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    x = _images(2, 64)
    want, wheads = jvit.forward(jcfg, jp, jnp.asarray(x), RULES)
    got, heads = tvit.forward(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == dtype_of(dtype) and got.shape == (2, 16)
    _close(got, want, TOL[dtype])
    assert (heads is None) == (wheads is None) == (arch == "vit-b16")
    if heads is not None:
        for g, w in zip(heads, wheads):
            _close(g, w, TOL[dtype])
    _close(tvit.serve(tcfg, tp, torch.from_numpy(x)),
           jvit.serve(jcfg, jp, jnp.asarray(x), RULES), TOL[dtype])


@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_forward_flash_matches_jax_flash_interpret(arch):
    """``impl="flash"`` (K6's plain version on the CPU) against the JAX
    Pallas kernel in interpret mode, float32 within 1e-4; and equal to
    the port's own plain path within the same."""
    jcfg, tcfg, jp, tp = _pair(arch)
    x = _images(2, 64, seed=2)
    want, _ = jvit.forward(jcfg, jp, jnp.asarray(x), RULES,
                           impl="flash_interpret")
    got, _ = tvit.forward(tcfg, tp, torch.from_numpy(x), impl="flash")
    _close(got, want, 1e-4)
    plain, _ = tvit.forward(tcfg, tp, torch.from_numpy(x), impl="torch")
    _close(plain, np.asarray(got), 1e-4)


@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_conv_patch_embed_matches_jax(arch):
    """The "conv" stem ((p, p, C, d) kernel, strided VALID conv in JAX) is
    the same function as the port's product on patchified images."""
    jcfg, tcfg, jp, tp = _pair(arch, patch_embed="conv")
    assert tp["patch_embed"]["kernel"].shape == (16, 16, 3, 64)
    x = _images(2, 64, seed=3)
    want, _ = jvit.forward(jcfg, jp, jnp.asarray(x), RULES)
    got, _ = tvit.forward(tcfg, tp, torch.from_numpy(x))
    _close(got, want, 1e-4)


def test_fused_qkv_matches_jax():
    jcfg, tcfg, jp, tp = _pair("vit-b16", fused_qkv=True)
    assert "wqkv" in tp["layers"][0]["attn"]
    x = _images(2, 64, seed=4)
    want, _ = jvit.forward(jcfg, jp, jnp.asarray(x), RULES)
    got, _ = tvit.forward(tcfg, tp, torch.from_numpy(x))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("res", [128, 96, 32])
@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_position_resize_matches_jax(arch, res):
    """Images of another size than the config's (64): the 4x4 position
    grid resized to 8x8 and 6x6 (up: plain bilinear) and 2x2 (down: the
    triangle filter ``jax.image.resize`` antialiases with), within 1e-4."""
    jcfg, tcfg, jp, tp = _pair(arch)
    x = _images(2, res, seed=5)
    want, _ = jvit.forward(jcfg, jp, jnp.asarray(x), RULES, img_res=res)
    got, _ = tvit.forward(tcfg, tp, torch.from_numpy(x), img_res=res)
    _close(got, want, 1e-4)
    side = res // 16
    grid = tp["pos_embed"][:, tcfg.n_tokens - 16:]
    wgrid = jax.image.resize(
        jnp.asarray(grid.numpy()).reshape(1, 4, 4, 64),
        (1, side, side, 64), "bilinear").reshape(1, side * side, 64)
    _close(tvit.resize_grid(grid, side), np.asarray(wgrid), 1e-6)
    with pytest.raises(ValueError, match="img_res"):
        tvit.forward(tcfg, tp, torch.from_numpy(x), img_res=res + 16)


@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_cls_loss_matches_jax(arch):
    """The float32 cross-entropy (DeiT: the mean of its two heads'),
    labels past the classes clamped, within 1e-4."""
    jcfg, tcfg, jp, tp = _pair(arch)
    x = _images(3, 64, seed=6)
    labels = np.array([0, 7, 99], np.int32)
    want = jvit.cls_loss(jcfg, jp, {"images": jnp.asarray(x),
                                    "labels": jnp.asarray(labels)}, RULES)
    got = tvit.cls_loss(tcfg, tp, {"images": torch.from_numpy(x),
                                   "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-4,
                               rtol=1e-4)


def test_bf16_convert_keeps_bits():
    jcfg, tcfg, jp, tp = _pair("deit-b", "bfloat16")
    for got, want in ((tp["dist_token"], jp["dist_token"]),
                      (tp["layers"][1]["attn"]["wq"],
                       jp["layers"]["attn"]["wq"][1])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_init_params_follow_the_specs():
    cfg = reduce_arch(configs.get("deit-b"))
    p = tvit.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert map_tree(lambda t: tuple(t.shape), p) == map_tree(
        lambda s: s.shape, tvit.param_specs(cfg))
    assert abs(float(p["pos_embed"].std()) - 0.02) < 0.005
    assert not p["head"]["bias"].any()
