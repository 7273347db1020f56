"""Every model's training loss and its gradient: the port (``torch.autograd``
through ``training.train_state.value_and_grad``) against the JAX package
(``jax.value_and_grad``) on parameters converted from the JAX tree, with
every leaf moved by N(0, 0.05) so that zero and one inits (biases, norm
affines, DiT's adaLN-zero projections) carry gradient, at the reduced
sizes of the other parity tests.  Also the grid assignment of detector
targets (bit-equal), the LM's causal ``"xla"`` / ``"chunked"`` attention,
remat, and the autograd guard of the kernel dispatchers.

Tolerances (float32): the loss within 1e-5 relative; each gradient leaf
within 1e-4 of that leaf's max-abs (summation order differs between XLA
and PyTorch's CPU kernels), the max-abs taken at least 1% of the tree's
largest: a leaf whose gradient vanishes analytically (EfficientNet's
project batch-norm biases, each followed by a training-mode batch norm,
which no shift reaches) holds only rounding noise, about 2e-7 of the
largest gradient."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.config import DetectorConfig as JDetectorConfig
from repro.configs import get as jget
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import attention as jattn
from repro.models import detector as jdet
from repro.models import dit as jdit
from repro.models import efficientnet as jeff
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models import vit as jvit
from repro.sharding import ShardingConfig
from repro_torch import configs
from repro_torch.config import DetectorConfig
from repro_torch.configs.reduced import reduce_arch
from repro_torch.kernels import launches
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.stitch import ref as stitch_ref
from repro_torch.models import attention as tattn
from repro_torch.models import detector as tdet
from repro_torch.models import dit as tdit
from repro_torch.models import efficientnet as teff
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models import vit as tvit
from repro_torch.param import sorted_leaves
from repro_torch.training.train_state import value_and_grad

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DET = dict(name="det", canvas=128, patch=32, n_layers=2, d_model=64,
           n_heads=4, d_ff=128, param_dtype="float32",
           compute_dtype="float32")


def perturbed(params, seed=0, scale=0.05):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        x + jnp.asarray(rng.normal(size=x.shape) * scale, x.dtype)
        for x in leaves])


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def hold_grads(got, want, tol=GRAD_TOL):
    """Leaf by leaf (both trees in the port's structure): within ``tol``
    of the leaf's max-abs, or of 1% of the tree's largest if more."""
    got, want = sorted_leaves(got), sorted_leaves(want)
    assert len(got) == len(want)
    floor = 0.01 * max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().float().numpy(), w.float().numpy()
        scale = max(float(np.abs(w).max()), floor, 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, (
            i, g.shape, float(np.abs(g - w).max()), scale)


def hold_loss_and_grads(jloss_fn, jparams, tloss_fn, tparams, convert):
    """The loss and every gradient leaf of both packages; ``convert``
    takes the JAX gradient tree (numpy) to the port's, in float32."""
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jparams)
    tl, tg = value_and_grad(lambda p, _: tloss_fn(p), tparams, None)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    hold_grads(tg, convert(as_numpy(jg)))
    return tl


# ------------------------------------------------------------ detector ----

def _boxes_case():
    """Boxes with a planted collision (two valid boxes in one cell), a
    padding box after real ones and a real box in cell (0, 0)."""
    rng = np.random.default_rng(3)
    b, k = 3, 8
    boxes = np.zeros((b, k, 4), np.float32)
    valid = np.zeros((b, k), bool)
    for i in range(b):
        n = 5 + i
        x0 = rng.uniform(-10, 120, n)
        y0 = rng.uniform(-10, 120, n)
        boxes[i, :n] = np.stack([x0, y0, x0 + rng.uniform(0.2, 40, n),
                                 y0 + rng.uniform(0.2, 40, n)], -1)
        valid[i, :n] = True
    boxes[0, 1] = boxes[0, 0] + 1.5       # collides with box 0: later wins
    boxes[1, 0] = (2, 3, 20, 25)          # a real box in cell (0, 0) ...
    valid[1, 7] = False                   # ... a padding box after it
    boxes[2, 3] = (40, 40, 41, 41)        # w, h clamped up to 1
    return boxes, valid


def test_targets_from_boxes_bit_equal():
    """Cells, objectness and the (dx, dy) offsets bit-equal; log w and log
    h within one ulp (XLA's and PyTorch's CPU ``log`` differ in the last
    bit on some inputs), zero exactly where the reference's are."""
    jcfg, tcfg = JDetectorConfig(**DET), DetectorConfig(**DET)
    boxes, valid = _boxes_case()
    jo, jb = jdet.targets_from_boxes(jcfg, jnp.asarray(boxes),
                                     jnp.asarray(valid))
    to, tb = tdet.targets_from_boxes(tcfg, torch.from_numpy(boxes),
                                     torch.from_numpy(valid))
    jb = np.asarray(jb)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb[..., :2].numpy(), jb[..., :2])
    np.testing.assert_array_equal(tb.numpy() == 0, jb == 0)
    np.testing.assert_array_max_ulp(tb[..., 2:].numpy(), jb[..., 2:], 1)
    # the padding box zeroed the real box's target in cell (0, 0) of
    # canvas 1 while objectness kept its 1, as in the reference
    assert to[1, 0, 0] == 1 and torch.all(tb[1, 0, 0] == 0)


def test_detection_loss_and_grads_match_jax():
    jcfg, tcfg = JDetectorConfig(**DET), DetectorConfig(**DET)
    jp = perturbed(jparam.init_params(jax.random.PRNGKey(0),
                                      jdet.param_specs(jcfg)))
    tp = tdet.convert_params(as_numpy(jp), tcfg, CPU)
    boxes, valid = _boxes_case()
    canv = np.random.default_rng(1).normal(
        size=(3, 128, 128, 3)).astype(np.float32)
    jb = {"canvases": jnp.asarray(canv), "boxes": jnp.asarray(boxes),
          "valid": jnp.asarray(valid)}
    tb = {"canvases": torch.from_numpy(canv),
          "boxes": torch.from_numpy(boxes), "valid": torch.from_numpy(valid)}
    hold_loss_and_grads(
        lambda p: jdet.detection_loss(jcfg, p, jb, RULES), jp,
        lambda p: tdet.detection_loss(tcfg, p, tb), tp,
        lambda g: tdet.convert_params(g, tcfg, CPU, dtype=torch.float32))


def test_log_sigmoid_and_sigmoid_grad_match_jax():
    x = np.concatenate([np.linspace(-120, 120, 241),
                        np.random.default_rng(0).normal(size=64) * 5]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(
        tlayers.log_sigmoid(torch.from_numpy(x)).numpy(), want,
        rtol=1e-6, atol=1e-7)
    for fn, jfn in ((tlayers.sigmoid, jax.nn.sigmoid),
                    (tlayers.log_sigmoid, jax.nn.log_sigmoid)):
        t = torch.from_numpy(x).requires_grad_(True)
        fn(t).sum().backward()
        jg = np.asarray(jax.grad(lambda v: jfn(v).sum())(jnp.asarray(x)))
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------------------------ LM ----

def _lm_pair(arch):
    jcfg = dataclasses.replace(jreduce(jget(arch).model))
    tcfg = reduce_arch(configs.get(arch))
    jp = perturbed(jparam.init_params(jax.random.PRNGKey(0),
                                      jtfm.param_specs(jcfg)))
    return jcfg, tcfg, jp, ttfm.convert_params(as_numpy(jp), tcfg, CPU)


def _lm_batch(vocab, b=2, s=1024, seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.mark.parametrize("arch", ["minitron-4b", "deepseek-moe-16b"])
def test_lm_loss_and_grads_match_jax(arch):
    """Dense and MoE (with its aux loss), two loss chunks of 512."""
    jcfg, tcfg, jp, tp = _lm_pair(arch)
    tokens, labels = _lm_batch(tcfg.vocab)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    loss = hold_loss_and_grads(
        lambda p: jtfm.lm_loss(jcfg, p, jb, RULES), jp,
        lambda p: ttfm.lm_loss(tcfg, p, tb), tp,
        lambda g: ttfm.convert_params(g, tcfg, CPU, dtype=torch.float32))
    with torch.no_grad():
        _, aux = ttfm.forward(tcfg, tp, tb["tokens"], impl="xla")
    assert (float(aux) > 0) == (tcfg.moe is not None)
    assert float(loss) > 0


def test_chunked_softmax_xent_matches_jax():
    """Three chunks, gold indices out of range on both sides (a negative
    one counts from the end, then all are clipped, as in JAX)."""
    rng = np.random.default_rng(4)
    b, s, d, v = 2, 48, 16, 40
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    labels = rng.integers(-v - 5, v + 5, size=(b, s)).astype(np.int32)

    def jloss(x, w):
        return jlayers.chunked_softmax_xent(
            lambda h: h @ w, x, jnp.asarray(labels), v, 16, jnp.float32)

    jl, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = tlayers.chunked_softmax_xent(lambda h: h @ tw, tx,
                                      torch.from_numpy(labels), 16)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    hold_grads([tx.grad, tw.grad], [torch.from_numpy(np.array(jgx)),
                                    torch.from_numpy(np.array(jgw))])


@pytest.mark.parametrize("impl,s", [("xla", 256), ("chunked", 4096)])
def test_causal_attention_paths_match_jax(impl, s):
    """``"chunked"`` at S=4096 runs two chunks of 2048 (tiny heads: 4 over
    2, D 8); gradients of the projections too."""
    rng = np.random.default_rng(5)
    d, h, kv, dh = 16, 4, 2, 8
    x = rng.normal(size=(1, s, d)).astype(np.float32)
    w = {"wq": rng.normal(size=(d, h, dh)) * 0.3,
         "wk": rng.normal(size=(d, kv, dh)) * 0.3,
         "wv": rng.normal(size=(d, kv, dh)) * 0.3,
         "wo": rng.normal(size=(h, dh, d)) * 0.3}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    kw = dict(n_heads=h, n_kv_heads=kv, rope_theta=10_000.0)
    assert (tattn._chunk_size(s) < s) == (impl == "chunked")

    def jfn(p):
        return jattn.attention(p, jnp.asarray(x), compute_dtype=jnp.float32,
                               rules=RULES, impl=impl, **kw)

    jout, vjp = jax.vjp(jfn, {k: jnp.asarray(v) for k, v in w.items()})
    cot = rng.normal(size=jout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    tout = tattn.attention(tw, torch.from_numpy(x),
                           compute_dtype=torch.float32, impl=impl, **kw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    tout.backward(torch.from_numpy(cot))
    hold_grads({k: t.grad for k, t in tw.items()},
               {k: torch.from_numpy(np.array(v)) for k, v in jg.items()})


def test_chunked_equals_xla_in_the_port():
    torch.manual_seed(0)
    q = torch.randn(1, 4096, 4, 8)
    k, v = torch.randn(1, 4096, 2, 8), torch.randn(1, 4096, 2, 8)
    got = tattn._chunked_causal(q, k, v, 2)
    want = attn_ref.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


# -------------------------------------------------------------- the zoo ----

@pytest.mark.parametrize("arch", ["vit-b16", "deit-b"])
def test_vit_cls_loss_and_grads_match_jax(arch):
    jcfg, tcfg = jreduce(jget(arch).model), reduce_arch(configs.get(arch))
    jp = perturbed(jparam.init_params(jax.random.PRNGKey(0),
                                      jvit.param_specs(jcfg)))
    tp = tvit.convert_params(as_numpy(jp), tcfg, CPU)
    rng = np.random.default_rng(6)
    images = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 15, 40], np.int32)          # 40 is clamped
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    hold_loss_and_grads(
        lambda p: jvit.cls_loss(jcfg, p, jb, RULES), jp,
        lambda p: tvit.cls_loss(tcfg, p, tb), tp,
        lambda g: tvit.convert_params(g, tcfg, CPU, dtype=torch.float32))


def test_efficientnet_cls_loss_and_grads_match_jax():
    """Training-mode batch norm: the kept statistics get zero gradients."""
    jcfg = jreduce(jget("efficientnet-b7").model)
    tcfg = reduce_arch(configs.get("efficientnet-b7"))
    jp = perturbed(jparam.init_params(jax.random.PRNGKey(0),
                                      jeff.param_specs(jcfg)))
    tp = teff.convert_params(as_numpy(jp), tcfg, CPU)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 11], np.int32)
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    hold_loss_and_grads(
        lambda p: jeff.cls_loss(jcfg, p, jb, RULES), jp,
        lambda p: teff.cls_loss(tcfg, p, tb), tp,
        lambda g: teff.convert_params(g, tcfg, CPU, dtype=torch.float32))
    _, grads = value_and_grad(lambda p, b: teff.cls_loss(tcfg, p, b), tp, tb)
    assert not grads["stem_bn"]["mean"].any()


def test_dit_diffusion_loss_and_grads_match_jax():
    jcfg, tcfg = jreduce(jget("dit-xl2").model), reduce_arch(
        configs.get("dit-xl2"))
    jp = perturbed(jparam.init_params(jax.random.PRNGKey(0),
                                      jdit.param_specs(jcfg)))
    tp = tdit.convert_params(as_numpy(jp), tcfg, CPU)
    rng = np.random.default_rng(8)
    batch = {"latents": rng.normal(size=(2, 8, 8, 4)).astype(np.float32),
             "noise": rng.normal(size=(2, 8, 8, 4)).astype(np.float32),
             "t": np.array([10, 900], np.int32),
             "labels": np.array([1, 16], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    hold_loss_and_grads(
        lambda p: jdit.diffusion_loss(jcfg, p, jb, RULES), jp,
        lambda p: tdit.diffusion_loss(tcfg, p, tb), tp,
        lambda g: tdit.convert_params(g, tcfg, CPU, dtype=torch.float32))


# ---------------------------------------------------------------- remat ----

def _remat_grads(loss_of, cfg, params, batch, **remat):
    cfg = dataclasses.replace(cfg, **remat)
    return value_and_grad(lambda p, b: loss_of(cfg, p, b), params, batch)


@pytest.mark.parametrize("family", ["lm", "detector", "dit"])
def test_remat_changes_no_value(family):
    """Remat on (each policy the family has) against off: the loss bit for
    bit, and every gradient leaf within 1e-6 of its max-abs.  Recomputing
    repeats the same ops on the same values; what may move is the order
    in which a leaf's gradient contributions add up (the LM's embedding
    gathers them through each layer's rebuilt graph)."""
    if family == "lm":
        cfg = reduce_arch(configs.get("deepseek-moe-16b"))
        params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
        tokens, labels = _lm_batch(cfg.vocab, s=128)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}
        loss_of, variants = ttfm.lm_loss, [
            dict(remat=True, remat_policy="dots"),
            dict(remat=True, remat_policy="minimal")]
    elif family == "detector":
        cfg = DetectorConfig(**DET)
        params = tdet.init_params(cfg, torch.Generator().manual_seed(0), CPU)
        boxes, valid = _boxes_case()
        batch = {"canvases": torch.randn(3, 128, 128, 3),
                 "boxes": torch.from_numpy(boxes),
                 "valid": torch.from_numpy(valid)}
        loss_of, variants = tdet.detection_loss, [dict(remat=True)]
    else:
        cfg = reduce_arch(configs.get("dit-s2"))
        params = tdit.init_params(cfg, torch.Generator().manual_seed(0), CPU)
        with torch.no_grad():
            for leaf in sorted_leaves(params):
                leaf.add_(0.05 * torch.randn(leaf.shape))
        batch = {"latents": torch.randn(2, 8, 8, 4),
                 "noise": torch.randn(2, 8, 8, 4),
                 "t": torch.tensor([5, 500]), "labels": torch.tensor([1, 2])}
        loss_of, variants = tdit.diffusion_loss, [dict(remat=True)]
    base_loss, base = _remat_grads(loss_of, cfg, params, batch, remat=False)
    for kw in variants:
        loss, grads = _remat_grads(loss_of, cfg, params, batch, **kw)
        assert torch.equal(loss, base_loss), kw
        hold_grads(grads, base, tol=1e-6)


# -------------------------------------------------- the autograd guard ----

def test_plain_kernel_versions_are_differentiable():
    """The plain versions of K1-K7, which a CPU tensor runs, carry
    gradients to every floating input."""
    torch.manual_seed(0)
    q = torch.randn(1, 16, 4, 8, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, requires_grad=True)
    v = torch.randn(1, 16, 2, 8, requires_grad=True)
    (attn_ref.mha_reference(q, k, v, causal=True).sum()
     + attn_ref.decode_reference(q[:, :1], k, v, 7).sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))

    slots = torch.randn(2, 8, 8, 3, requires_grad=True)
    records = torch.tensor([[[1, 0, 0, 0, 8, 8], [1, 1, 8, 4, 8, 8]]],
                           dtype=torch.int32)
    canv = stitch_ref.stitch_reference(slots, records, 16, 16)
    back = stitch_ref.unstitch_reference(canv, records, 2, 8, 8)
    kernel = torch.randn(4 * 4 * 3, 8, requires_grad=True)
    bias = torch.randn(8, requires_grad=True)
    tokens = stitch_ref.stitch_embed_reference(slots, records, kernel, bias,
                                               16, 16, 4)
    raw = torch.randn(1, 4, 4, 5, requires_grad=True)
    dec = stitch_ref.unstitch_decode_reference(raw, records, 4, 2)
    (back.sum() + tokens.sum() + dec.sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (slots, kernel, bias, raw))

    state = {"w": torch.full((4, 4, 3), 1 / 3, requires_grad=True),
             "mu": torch.rand(4, 4, 3, requires_grad=True),
             "var": torch.full((4, 4, 3), 0.01, requires_grad=True)}
    frame = torch.rand(4, 4, requires_grad=True)
    new, _ = gmm_ref.gmm_update_reference(state, frame)
    sum(x.sum() for x in new.values()).backward()
    assert frame.grad is not None and state["mu"].grad is not None


def test_refuse_grad_raises_only_under_autograd():
    x = torch.randn(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        launches.refuse_grad("flash_attention", torch.randn(2), x)
    with torch.no_grad():
        launches.refuse_grad("flash_attention", x)
    launches.refuse_grad("stitch", torch.randn(2, 3),
                         torch.zeros(3, dtype=torch.int32))
