"""int8-resident weights and KV cache in the port against the JAX
package's: the quantized values and scales, the int8 detector and LM
forward, the int8 KV-cache decode, spec economics, and ``tangram_int8``.

Inputs are numpy arrays from a seed.  The JAX side quantizes its own fp
tree (``repro.models.quantize.quantize_params``) and runs its int8
functions (decode also through the Pallas K7 in interpret mode); the port
takes the JAX fp tree through ``convert_params``, quantizes it with its
own ``quantize_params``, and runs on the CPU, where K6 and K7 take their
plain versions.  Quantized values and scales must be bit-equal.
Tolerances of the forwards: 1e-4 in float32, 2e-2 in bfloat16 (relative
L2 for the LM, as in ``tests/test_torch_transformer.py``; elementwise for
the detector, as in ``tests/test_torch_detector.py``).  fp-vs-int8
correlation bounds are the JAX tests' own (``tests/test_quantize.py``,
``tests/test_int8_serving.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.config import DetectorConfig as JDetectorConfig
from repro.configs import minitron_4b as jarch
from repro.configs.reduced import reduce_arch as jreduce
from repro.core import models as jmodels
from repro.models import detector as jdet
from repro.models import layers as jlayers
from repro.models import quantize as jquantize
from repro.models import transformer as jtr
from repro.sharding import ShardingConfig
from repro_torch import param as tparam
from repro_torch.config import DetectorConfig
from repro_torch.configs import get
from repro_torch.configs.reduced import reduce_arch as treduce
from repro_torch.core import models as tmodels
from repro_torch.core.latency import LatencyTable
from repro_torch.models import attention as tattn
from repro_torch.models import detector as tdet
from repro_torch.models import layers as tlayers
from repro_torch.models import quantize as tquantize
from repro_torch.models import transformer as ttr

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
B, S, SMAX = 2, 32, 32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DET_DIMS = dict(name="det", canvas=128, patch=32, n_layers=2, d_model=64,
                n_heads=4, d_ff=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * scale, x.dtype),
        tree)


def _flat(tree, path=()):
    """{path: leaf} of nested dicts and lists (JAX trees come back with
    their dict keys sorted, so leaves are matched by path, not order)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def _same_leaves(got, want):
    """Every leaf bit-equal, in the same dtype, at the same path."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) and len(g) > 0
    for path, a in g.items():
        b = w[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


# ------------------------------------------------------------------ LM ----

def _lm(dtype="float32", scan=True, **kw):
    """(jax fp cfg, jax int8 cfg, port fp cfg, port int8 cfg, jax fp
    params, jax int8 params, port fp params, port int8 params)."""
    jcfg = dataclasses.replace(jreduce(jarch.ARCH), param_dtype=dtype,
                               compute_dtype=dtype, scan_layers=scan, **kw)
    tcfg = dataclasses.replace(treduce(get("minitron-4b")),
                               param_dtype=dtype, compute_dtype=dtype, **kw)
    jq = dataclasses.replace(jcfg, quant_weights=True)
    tq = dataclasses.replace(tcfg, quant_weights=True)
    jp = _perturb(jparam.init_params(jax.random.PRNGKey(0),
                                     jtr.param_specs(jcfg)))
    jqp = jquantize.quantize_params(jtr.param_specs(jq), jp)
    tp = ttr.convert_params(_np(jp), tcfg, CPU)
    tqp = tquantize.quantize_params(ttr.param_specs(tq), tp)
    return jcfg, jq, tcfg, tq, jp, jqp, tp, tqp


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        return
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < TOL[dtype], err


def _tokens(seed=1, s=S):
    return np.random.default_rng(seed).integers(0, 512, size=(B, s)) \
        .astype(np.int32)


def _corr(a, b):
    return np.corrcoef(np.asarray(a, np.float32).ravel(),
                       np.asarray(b, np.float32).ravel())[0, 1]


@pytest.mark.parametrize("variant", [{}, {"fused_qkv": True},
                                     {"tie_embeddings": True}],
                         ids=["split", "fused_qkv", "tied"])
@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_quantized_values_bit_equal_jax(dtype, scan, variant):
    """The port's quantize_params over the converted fp tree equals the
    JAX int8 tree converted (scanned or ``layer_{i}``): int8 values and
    float32 scales bit for bit, the unquantized leaves too."""
    *_, tq, _, jqp, _, tqp = _lm(dtype, scan, **variant)
    converted = ttr.convert_params(_np(jqp), tq, CPU)
    _same_leaves(tqp, converted)
    attn = tqp["layers"]["layer_1"]["attn"]
    w = attn["wqkv"] if variant.get("fused_qkv") else attn["wo"]
    assert w["q"].dtype == torch.int8 and w["scale"].dtype == torch.float32
    assert int(w["q"].abs().max()) == 127
    assert ("lm_head" in tqp) != bool(variant.get("tie_embeddings"))
    if "lm_head" in tqp:
        assert tqp["lm_head"]["kernel_q"].dtype == torch.int8
    # the embedding and the norms stay in the param dtype
    assert tqp["embed"]["embedding"].dtype == getattr(torch, dtype)
    assert tqp["ln_f"]["scale"].dtype == getattr(torch, dtype)


def test_quantize_dense_and_kernel_equal_jax():
    rng = np.random.default_rng(3)
    for shape in ((64, 48), (1, 5), (33, 7)):
        k = rng.normal(size=shape).astype(np.float32)
        k[:, 0] = 0.0                          # an all-zero channel
        want = jlayers.quantize_dense(jnp.asarray(k))
        got = tlayers.quantize_dense(torch.from_numpy(k))
        np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                      np.asarray(want["kernel_q"]))
        np.testing.assert_array_equal(got["kernel_scale"].numpy(),
                                      np.asarray(want["kernel_scale"]))
    # round half to even, as jnp.round: 0.5 / 1.5 / 2.5 steps of the scale
    k = torch.tensor([[127.0], [0.5], [1.5], [2.5], [-2.5]])
    q, _ = tquantize.quantize_kernel(k, 1)
    assert q[:, 0].tolist() == [127, 0, 2, 2, -2]
    with pytest.raises(ValueError, match="trailing axes"):
        tquantize._quantize_kernel(torch.zeros(4, 3), tparam.spec((4, 3)),
                                   tparam.spec((4,)))


@pytest.mark.parametrize("jimpl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_int8_forward_and_prefill_match_jax(dtype, jimpl):
    jcfg, jq, tcfg, tq, jp, jqp, tp, tqp = _lm(dtype)
    tok = _tokens()
    jh, _ = jtr.forward(jq, jqp, jnp.asarray(tok), RULES, impl=jimpl)
    th, _ = ttr.forward(tq, tqp, torch.from_numpy(tok))
    _close(th, jh, dtype)
    jl, _ = jtr.prefill(jq, jqp, jnp.asarray(tok), RULES, impl=jimpl)
    tl, _ = ttr.prefill(tq, tqp, torch.from_numpy(tok))
    _close(tl, jl, dtype)
    # int8 tracks fp (tests/test_quantize.py's decode bound)
    fl, _ = ttr.prefill(tcfg, tp, torch.from_numpy(tok))
    assert _corr(tl.float(), fl.float()) > 0.99


@pytest.mark.parametrize("jimpl", ["xla", "flash_decode_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_int8_weights_decode_matches_jax(dtype, jimpl):
    _, jq, _, tq, _, jqp, _, tqp = _lm(dtype)
    tok = _tokens(seed=2)
    jcache = jtr.init_cache(jq, B, SMAX)
    tcache = ttr.init_cache(tq, B, SMAX, CPU)
    for pos in range(6):
        t = tok[:, pos:pos + 1]
        jl, jcache = jtr.decode_step(jq, jqp, jnp.asarray(t), jcache, pos,
                                     RULES, impl=jimpl)
        tl, tcache = ttr.decode_step(tq, tqp, torch.from_numpy(t), tcache,
                                     pos)
        _close(tl, jl, dtype)


@pytest.mark.parametrize("jimpl", ["xla", "flash_decode_interpret"])
@pytest.mark.parametrize("weights", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_int8_kv_cache_decode_matches_jax(dtype, weights, jimpl):
    """The int8 KV cache over 6 decode steps (tests/test_quantize.py's
    case): the port writes values and scales in place at ``pos`` and
    dequantizes for attention; logits match the JAX int8-cache decode,
    the cache holds the JAX cache's int8 values and scales, and the
    logits track the fp cache's (correlation > 0.995)."""
    jcfg, jq, tcfg, tq, jp, jqp, tp, tqp = _lm(dtype)
    if weights == "int8":
        jcfg, tcfg, jp, tp = jq, tq, jqp, tqp
    jkv = dataclasses.replace(jcfg, quant_kv=True)
    tkv = dataclasses.replace(tcfg, quant_kv=True)
    rng = np.random.default_rng(0)
    jcache = jtr.init_cache(jkv, B, SMAX)
    tcache = ttr.init_cache(tkv, B, SMAX, CPU)
    fp_cache = ttr.init_cache(tcfg, B, SMAX, CPU)
    k0 = tcache["layer_0"]["k"]
    assert k0.dtype == torch.int8
    assert tcache["layer_0"]["k_scale"].shape == (B, SMAX, tcfg.n_kv_heads)
    for pos in range(6):
        tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
        jl, jcache = jtr.decode_step(jkv, jp, jnp.asarray(tok), jcache, pos,
                                     RULES, impl=jimpl)
        tl, tcache = ttr.decode_step(tkv, tp, torch.from_numpy(tok), tcache,
                                     pos)
        fl, fp_cache = ttr.decode_step(tcfg, tp, torch.from_numpy(tok),
                                       fp_cache, pos)
        _close(tl, jl, dtype)
    assert tcache["layer_0"]["k"] is k0            # written in place
    assert not tcache["layer_0"]["k"][:, 6:].any()
    # the first layer's cache holds the JAX cache's int8 values and
    # scales, but for roundings moved by the last ulp of the K projection
    jk = np.asarray(jcache["k"][0]).astype(int)
    tk = tcache["layer_0"]["k"].numpy().astype(int)
    assert np.abs(tk - jk).max() <= (1 if dtype == "float32" else 2)
    assert (tk != jk).mean() < (0.01 if dtype == "float32" else 0.1)
    np.testing.assert_allclose(tcache["layer_0"]["v_scale"].numpy(),
                               np.asarray(jcache["v_scale"][0]),
                               rtol=TOL[dtype], atol=1e-6)
    assert _corr(tl.float(), fl.float()) > 0.995


def test_quant_param_bytes_shrink():
    """Quantized specs hold under 0.45x the fp bytes on a float32 base
    (``tests/test_quantize.py``'s config), and the same bytes as the JAX
    package's spec trees, LM and detector."""
    def nbytes(specs):
        return sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
                   .element_size() for s in tparam.leaves(specs))

    def jbytes(specs):
        return sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
                   for s in jax.tree_util.tree_leaves(
                       specs, is_leaf=lambda x: isinstance(x,
                                                           jparam.ParamSpec)))

    dims = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, head_dim=16, param_dtype="float32",
                compute_dtype="float32")
    base = dataclasses.replace(treduce(get("minitron-4b")), **dims)
    jbase = dataclasses.replace(jreduce(jarch.ARCH), **dims)
    for q in (False, True):
        t = dataclasses.replace(base, quant_weights=q)
        j = dataclasses.replace(jbase, quant_weights=q)
        assert nbytes(ttr.param_specs(t)) == jbytes(jtr.param_specs(j))
    fp = nbytes(ttr.param_specs(base))
    assert nbytes(ttr.param_specs(dataclasses.replace(
        base, quant_weights=True))) < 0.45 * fp
    det = DetectorConfig(**DET_DIMS)
    qdet = dataclasses.replace(det, quant_weights=True)
    jdet_cfg = JDetectorConfig(**DET_DIMS)
    jq = dataclasses.replace(jdet_cfg, quant_weights=True)
    assert nbytes(tdet.param_specs(qdet)) == jbytes(jdet.param_specs(jq))
    assert nbytes(tdet.param_specs(det)) == jbytes(jdet.param_specs(jdet_cfg))
    # the trunk's kernels shrink 4x; patch embed, pos embed, head stay
    trunk = lambda specs: nbytes(specs["trunk"]["layers"])
    assert trunk(tdet.param_specs(qdet)) < 0.3 * trunk(tdet.param_specs(det))


def test_quant_spec_shapes_equal_jax():
    """The quantized LM spec tree's shapes and dtypes are the JAX
    package's (unscanned)."""
    jcfg = dataclasses.replace(jreduce(jarch.ARCH), quant_weights=True,
                               scan_layers=False, quant_kv=True)
    tcfg = dataclasses.replace(treduce(get("minitron-4b")),
                               quant_weights=True, quant_kv=True)
    want = jax.tree_util.tree_map(
        lambda s: (s.shape, np.dtype(s.dtype).name), jtr.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jparam.ParamSpec))
    got = tparam.map_tree(
        lambda s: (s.shape, str(s.dtype).replace("torch.", "")),
        ttr.param_specs(tcfg))
    assert got == want
    jc = jtr.init_cache(jcfg, B, SMAX)
    tc = ttr.init_cache(tcfg, B, SMAX, CPU)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc["layer_0"].items()} == \
        {k: (tuple(v.shape), v.dtype.name)
         for k, v in jc["layer_0"].items()}


# ------------------------------------------------------------ detector ----

def _det(dtype, scan=True):
    jcfg = JDetectorConfig(**DET_DIMS, param_dtype=dtype, compute_dtype=dtype,
                           scan_layers=scan)
    tcfg = DetectorConfig(**DET_DIMS, param_dtype=dtype, compute_dtype=dtype)
    jq = dataclasses.replace(jcfg, quant_weights=True)
    tq = dataclasses.replace(tcfg, quant_weights=True)
    jp = _perturb(jparam.init_params(jax.random.PRNGKey(0),
                                     jdet.param_specs(jcfg)))
    jqp = jquantize.quantize_params(jdet.param_specs(jq), jp)
    tp = tdet.convert_params(_np(jp), tcfg, CPU)
    tqp = tquantize.quantize_params(tdet.param_specs(tq), tp)
    return jcfg, jq, tcfg, tq, jp, jqp, tp, tqp


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_quantized_values_bit_equal_jax(dtype, scan):
    *_, tq, _, jqp, _, tqp = _det(dtype, scan)
    _same_leaves(tqp, tdet.convert_params(_np(jqp), tq, CPU))
    layer = tqp["trunk"]["layers"][0]
    assert layer["attn"]["wo"]["scale"].shape == (DET_DIMS["d_model"],)
    assert layer["mlp"]["fc1"]["kernel_q"].dtype == torch.int8
    assert layer["mlp"]["fc1"]["bias"].dtype == getattr(torch, dtype)
    # the patch embed (K4's weights) and the head stay full precision
    assert "kernel" in tqp["trunk"]["patch_embed"]
    assert "kernel" in tqp["det_head"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_int8_forward_matches_jax(dtype):
    jcfg, jq, tcfg, tq, jp, jqp, tp, tqp = _det(dtype)
    x = np.random.default_rng(1).normal(size=(2, 128, 128, 3)) \
        .astype(np.float32)
    want = np.asarray(jdet.forward(jq, jqp, jnp.asarray(x), RULES),
                      np.float32)
    got = tdet.forward(tq, tqp, torch.from_numpy(x))
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the fused path's trunk from tokens on the fp patch embed
    kernel, bias = tdet.embed_params(tq, tqp)
    tokens = tlayers.dense({"kernel": kernel, "bias": bias},
                           torch.from_numpy(x).reshape(2, 4, 32, 4, 32, 3)
                           .permute(0, 1, 3, 2, 4, 5).reshape(2, 16, -1),
                           kernel.dtype)
    np.testing.assert_allclose(
        tdet.forward_tokens(tq, tqp, tokens).float().numpy(), want,
        atol=TOL[dtype], rtol=TOL[dtype])
    fp = tdet.forward(tcfg, tp, torch.from_numpy(x)).float()
    assert _corr(got.float()[..., 0], fp[..., 0]) > 0.98


def test_detector_init_params_follow_specs():
    """An int8 config's ``init_params`` gives zeros in its int8 leaves,
    as ``jax param.init_params`` does; ``ModelSpec.build`` and
    ``build_detector`` quantize the fp init instead."""
    tq = DetectorConfig(**DET_DIMS, quant_weights=True)
    p = tdet.init_params(tq, torch.Generator().manual_seed(0), CPU)
    wq = p["trunk"]["layers"][1]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and not wq["q"].any()
    assert torch.equal(wq["scale"], torch.ones(4, 16))
    assert p["trunk"]["patch_embed"]["kernel"].std() > 0


# ---------------------------------------------------- registry, serving ----

def test_tangram_int8_spec_matches_reference_economics():
    for name in ("tangram", "tangram_int8"):
        t, j = tmodels.make_model(name), jmodels.make_model(name)
        assert (t.dtype, t.canvas_m, t.canvas_n, t.weight_bytes,
                t.load_s) == (j.dtype, j.canvas_m, j.canvas_n,
                              j.weight_bytes, j.load_s)
    fp, q = tmodels.make_model("tangram"), tmodels.make_model("tangram_int8")
    assert q.weight_bytes == fp.weight_bytes / 2        # bf16 -> int8
    mu_fp = fp.latency_table(max_batch=8).mu_sigma(8)[0]
    mu_q = q.latency_table(max_batch=8).mu_sigma(8)[0]
    assert mu_q < mu_fp
    with pytest.raises(ValueError, match="unsupported dtype"):
        tmodels.ModelSpec(name="bad", canvas_m=64, canvas_n=64,
                          weight_bytes=1e6,
                          table=LatencyTable({1: (0.1, 0.01)}), dtype="int4")


def test_tangram_int8_build_is_tangram_quantized():
    cfg_q, params_q, serve_q = tmodels.make_model("tangram_int8").build(
        canvas=128, device="cpu")
    cfg_fp, params_fp, serve_fp = tmodels.make_model("tangram").build(
        canvas=128, device="cpu")
    assert cfg_q.quant_weights and not cfg_fp.quant_weights
    want = tquantize.quantize_params(tdet.param_specs(cfg_q), params_fp)
    _same_leaves(params_q, want)
    leaves_q = list(tparam.leaves(params_q))
    assert any(t.dtype == torch.int8 for t in leaves_q)
    nbytes = lambda ls: sum(t.numel() * t.element_size() for t in ls)
    assert nbytes(leaves_q) < nbytes(tparam.leaves(params_fp))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 128, 128, 3)).astype(np.float32))
    obj_q, _ = serve_q(params_q, x)
    obj_fp, _ = serve_fp(params_fp, x)
    assert _corr(obj_q, obj_fp) > 0.98


def test_quantized_attention_weight_rounds_in_the_compute_dtype():
    """``weight`` multiplies int8 values by the scale in the compute
    dtype, as ``repro.models.attention.weight`` does."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, size=(16, 4, 8)).astype(np.int8)
    s = (rng.random((4, 8)) * 0.01).astype(np.float32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = tattn.weight({"q": torch.from_numpy(q),
                            "scale": torch.from_numpy(s)}, dt)
        want = jattn.weight({"q": jnp.asarray(q), "scale": jnp.asarray(s)},
                            jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
