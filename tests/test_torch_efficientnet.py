"""The EfficientNet classifier: the port's ``models/efficientnet.py``
forward pass against the JAX package's on parameters converted from the
JAX tree, on the same seeded images, at the reduced config (width 0.35,
depth 0.35: 7 MBConv blocks, 16 classes).

Inputs of 64 and 65 pixels: at stride 2 XLA's ``"SAME"`` pads an odd
size one more on the high side, which ``F.conv2d(padding=)`` cannot
express.  Batch norm in both modes: batch statistics (``train=True``) and
the kept ones (serving).

Tolerances: 1e-4 in float32 (summation order differs between XLA's and
PyTorch's CPU convolutions; the logits are O(1)); 2e-2 in bfloat16 (the
two frameworks round at the same places, the port's activations repeating
``jax.nn``'s ops, but sum the norms' statistics in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.configs import get as jget
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import efficientnet as jeff
from repro.sharding import ShardingConfig
from repro_torch import configs
from repro_torch.config import EfficientNetConfig, dtype_of
from repro_torch.configs.reduced import reduce_arch
from repro_torch.models import efficientnet as teff
from repro_torch.models import layers

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jreduce(jget("efficientnet-b7").model),
                               param_dtype=dtype, compute_dtype=dtype)
    tcfg = dataclasses.replace(reduce_arch(configs.get("efficientnet-b7")),
                               param_dtype=dtype, compute_dtype=dtype)
    params = jparam.init_params(jax.random.PRNGKey(0),
                                jeff.param_specs(jcfg))
    # move every leaf (the batch-norm affines and statistics too); the
    # running variances stay positive
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype)
              for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, leaves)
    tp = teff.convert_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             CPU)
    return jcfg, tcfg, jp, tp


def _images(b, res, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, res, res, 3)).astype(np.float32)


def test_config_and_n_params_equal_jax():
    cfg, jcfg = configs.get("efficientnet-b7"), jget("efficientnet-b7").model
    for f in dataclasses.fields(EfficientNetConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.n_params == jcfg.n_params == 66_585_480
    assert cfg.n_active_params == jcfg.n_active_params
    assert reduce_arch(cfg) == EfficientNetConfig(**{
        f.name: getattr(jreduce(jcfg), f.name)
        for f in dataclasses.fields(EfficientNetConfig)})


@pytest.mark.parametrize("size,k,stride", [(64, 3, 2), (65, 3, 2),
                                           (600, 3, 2), (299, 5, 2),
                                           (33, 5, 1), (8, 1, 1), (7, 3, 2)])
def test_same_padding_is_xla_same(size, k, stride):
    """Output ceil(size / stride); the odd pixel of padding goes high."""
    lo, hi = teff.same_padding(size, k, stride)
    x = jnp.ones((1, size, 1, 1))
    y = jax.lax.conv_general_dilated(
        x, jnp.ones((k, 1, 1, 1)), (stride, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert (size + lo + hi - k) // stride + 1 == y.shape[1] == -(-size //
                                                                 stride)
    # the window sums show where the padding went: the first output sees
    # k - lo ones, the last k - hi when the window reaches the high pad
    assert float(y[0, 0, 0, 0]) == min(k - lo, size)
    assert hi - lo in (0, 1)


FORWARD_CASES = [("float32", res, train) for res in (64, 65)
                 for train in (False, True)] + [("bfloat16", 64, False),
                                                ("bfloat16", 65, False)]


@pytest.mark.parametrize("dtype,res,train", FORWARD_CASES)
def test_forward_matches_jax(dtype, res, train):
    """The logits end to end.  bf16 with batch statistics is held block
    by block instead (``test_bf16_batch_statistics_blocks_match_jax``)."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    x = _images(2, res)
    want = np.asarray(jeff.forward(jcfg, jp, jnp.asarray(x), RULES,
                                   train=train), np.float32)
    got = teff.forward(tcfg, tp, torch.from_numpy(x), train=train)
    assert got.dtype == dtype_of(dtype) and got.shape == (2, 16)
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("res", [64, 65])
def test_bf16_batch_statistics_blocks_match_jax(res):
    """bf16 with ``train=True``: the stem and every MBConv block, each fed
    the JAX package's output of the block before, within 2e-2 of the JAX
    block (most elements bit-equal).  End to end the two differ by up to
    0.035 at the logits: batch norm over the last stages' 2 x 2 x 2 = 8
    samples turns a last-bit difference of a float32 channel mean (the
    two frameworks sum in other orders) into a bf16 step and amplifies it
    from block to block, so an end-to-end bound would be one on chaos,
    not on the port."""
    jcfg, tcfg, jp, tp = _pair("bfloat16")
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    x = _images(2, res)

    def same(j, t, what):
        j = np.asarray(j.astype(jnp.float32))
        assert t.dtype == tdt and t.shape == j.shape, what
        np.testing.assert_allclose(t.float().numpy(), j, atol=2e-2,
                                   rtol=2e-2, err_msg=what)

    jx = jax.nn.swish(jeff._bn(jp["stem_bn"], jeff._conv(
        jp["stem_conv"], jnp.asarray(x).astype(jdt), 2, jdt), True, jdt))
    tx = layers.silu(teff._bn(tp["stem_bn"], teff._conv(
        tp["stem_conv"], torch.from_numpy(x).to(tdt), 2, tdt), True, tdt))
    same(jx, tx, "stem")
    for i, b in enumerate(jeff.block_args(jcfg)):
        t_in = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
        jx = jeff._mbconv(jp["blocks"][f"block_{i}"], b, jx, True, jdt)
        same(jx, teff._mbconv(tp["blocks"][f"block_{i}"], b, t_in, True,
                              tdt), f"block {i}")


def test_serve_and_cls_loss_match_jax():
    """``serve`` is the kept-statistics pass; ``cls_loss`` the float32
    cross-entropy of the batch-statistics pass, labels clamped."""
    jcfg, tcfg, jp, tp = _pair()
    x = _images(3, 64, seed=2)
    labels = np.array([3, -4, 40], np.int32)
    np.testing.assert_allclose(
        teff.serve(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jeff.serve(jcfg, jp, jnp.asarray(x), RULES)), atol=1e-4,
        rtol=1e-4)
    want = jeff.cls_loss(jcfg, jp, {"images": jnp.asarray(x),
                                    "labels": jnp.asarray(labels)}, RULES)
    got = teff.cls_loss(tcfg, tp, {"images": torch.from_numpy(x),
                                   "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-4,
                               rtol=1e-4)


def test_convert_keeps_spec_dtypes_and_bf16_bits():
    """Batch-norm statistics stay float32 in a bf16 tree; bf16 leaves keep
    their bits."""
    jcfg, tcfg, jp, tp = _pair("bfloat16")
    bn = tp["blocks"]["block_1"]["dw_bn"]
    assert bn["mean"].dtype == bn["var"].dtype == torch.float32
    assert bn["scale"].dtype == torch.bfloat16
    got = tp["blocks"]["block_1"]["dw_conv"]["kernel"]
    want = np.asarray(jp["blocks"]["block_1"]["dw_conv"]["kernel"])
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    np.testing.assert_array_equal(
        bn["mean"].numpy(), np.asarray(jp["blocks"]["block_1"]["dw_bn"]
                                       ["mean"]))
