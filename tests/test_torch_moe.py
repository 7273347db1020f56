"""The port's MoE (``models/moe.py``, the MoE configs and the MoE
transformer) against the JAX package's, on the reduced ``deepseek-moe-16b``
(8 experts top-2, one shared expert) and ``llama4-scout-17b-a16e`` (8
experts top-1, none shared): 2 layers, d 128, experts of 64, groups of 64
tokens, the JAX parameters passed through ``convert_params``.

Inputs are numpy arrays from a seed.  The JAX side runs the plain XLA
attention and both Pallas kernels in interpret mode (``flash_interpret``
in prefill, ``flash_decode_interpret`` in decode); the port runs on the
CPU, where K6 and K7 take their plain versions.  Tolerances: the dispatch
tensor bit for bit and the combine weights and aux loss within 1e-6 on
identical gates; forwards within 1e-4 elementwise in float32 and 2e-2
relative L2 in bfloat16 (as ``tests/test_torch_transformer.py``); int8
values and scales bit for bit.  At these sizes in float32 no routing
choice sits close enough to a tie for XLA's and PyTorch's summation orders
to move it, so the routed outputs are held like dense ones.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.config import MoEConfig as JMoEConfig
from repro.configs import deepseek_moe_16b as jdeepseek
from repro.configs import llama4_scout_17b_a16e as jllama4
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import moe as jmoe
from repro.models import quantize as jquantize
from repro.models import transformer as jtr
from repro.sharding import ShardingConfig
from repro_torch import param as tparam
from repro_torch.config import MoEConfig
from repro_torch.configs import get
from repro_torch.configs.reduced import reduce_arch as treduce
from repro_torch.models import moe as tmoe
from repro_torch.models import quantize as tquantize
from repro_torch.models import transformer as ttr

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
B, S, SMAX, STEPS = 2, 64, 64, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JARCH = {"deepseek-moe-16b": jdeepseek.ARCH,
         "llama4-scout-17b-a16e": jllama4.ARCH}
ARCHS = list(JARCH)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jreduce(JARCH[arch]), param_dtype=dtype,
                               compute_dtype=dtype, **kw)
    tcfg = dataclasses.replace(treduce(get(arch)), param_dtype=dtype,
                               compute_dtype=dtype,
                               **{k: v for k, v in kw.items()
                                  if k != "scan_layers"})
    return jcfg, tcfg


def _pair(arch, dtype="float32", **kw):
    """JAX params (perturbed, so the norm scales are exercised off 1) and
    the port's conversion of them."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jparams = jparam.init_params(jax.random.PRNGKey(0),
                                 jtr.param_specs(jcfg))
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype),
        jparams)
    return jcfg, tcfg, jparams, ttr.convert_params(_np(jparams), tcfg, CPU)


def _tokens(seed=1, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, size=(B, s)).astype(np.int32)


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        return
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < TOL[dtype], err


# ------------------------------------------------------------- configs ----

def test_full_configs_and_counts_equal_jax():
    """Both MoE configs carry the JAX fields the port reads, and their
    total and active parameter counts (and the spec trees' sizes) equal
    the JAX package's."""
    counts = {"deepseek-moe-16b": (16_879_568_896, 2_830_747_648),
              "llama4-scout-17b-a16e": (101_730_063_360, 11_133_096_960)}
    for arch, (total, active) in counts.items():
        j, t = JARCH[arch], get(arch)
        tf = dataclasses.asdict(t)
        assert {k: v for k, v in dataclasses.asdict(j).items()
                if k in tf} == tf
        assert (t.n_params, t.n_active_params) == (j.n_params,
                                                   j.n_active_params)
        assert (t.n_params, t.n_active_params) == (total, active)
        assert tparam.count_params(ttr.param_specs(t)) == \
            jparam.count_params(jtr.param_specs(j)) == total
    # the reduced configs describe the same model in both packages
    for arch in ARCHS:
        j, t = _cfgs(arch)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert t.n_params == j.n_params
        assert t.n_active_params == j.n_active_params
    # the dense model counts every parameter as active
    assert get("minitron-4b").n_active_params == get("minitron-4b").n_params


@pytest.mark.parametrize("top_k", [1, 2, 6])
@pytest.mark.parametrize("n_experts", [4, 8, 16, 64])
def test_capacity_equals_jax(n_experts, top_k):
    for gs in (1, 2, 7, 64, 128, 512, 4096):
        for cf in (0.5, 1.0, 1.25, 2.0, n_experts / top_k):
            t = MoEConfig(n_experts, top_k, capacity_factor=cf)
            j = JMoEConfig(n_experts, top_k, capacity_factor=cf)
            assert tmoe.capacity(gs, t) == jmoe.capacity(gs, j)


# ------------------------------------------------------------ dispatch ----

CASES = ("generous", "tight", "decode")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_experts", [4, 8, 64])
@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_top_k_dispatch_equals_jax(top_k, n_experts, case):
    """On identical gates: dispatch bit for bit, combine and aux within
    1e-6.  "generous": a capacity of the whole group, nothing drops;
    "tight": capacity factor 0.5, tokens drop; "decode": a group of two
    alike tokens at capacity 1, where the second token's every choice
    drops."""
    rng = np.random.default_rng(top_k * 100 + n_experts)
    if case == "decode":
        g, s, cap = 1, 2, 1
        logits = np.repeat(rng.normal(size=(1, 1, n_experts)), 2, axis=1)
        logits[:, 1] += rng.normal(size=n_experts) * 1e-3
    else:
        g, s = 2, 64
        logits = rng.normal(size=(g, s, n_experts))
        cap = s if case == "generous" else jmoe.capacity(
            s, JMoEConfig(n_experts, top_k, capacity_factor=0.5))
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32),
                                      axis=-1))
    tcfg = MoEConfig(n_experts, top_k)
    jd, jc, ja = jmoe._top_k_dispatch(jnp.asarray(gates),
                                      JMoEConfig(n_experts, top_k), cap)
    td, tc, ta = tmoe._top_k_dispatch(torch.tensor(gates), tcfg, cap)
    assert td.shape == (g, s, n_experts, cap) and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)
    # no expert buffer slot holds two tokens
    assert float(td.sum(1).max()) <= 1.0
    if top_k > n_experts:       # later rounds re-pick a zeroed gate
        return
    kept = float(td.sum())
    want = {"generous": g * s * top_k, "decode": top_k}
    if case == "tight":
        assert kept < g * s * top_k
    else:
        assert kept == want[case]
    if case != "tight":         # the kept gates' weights sum to 1
        np.testing.assert_allclose(tc.numpy().sum((2, 3))[:, 0], 1.0,
                                   rtol=1e-6)


# --------------------------------------------------------------- block ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    cdt = getattr(torch, dtype)
    jspecs = jmoe.moe_specs(jcfg.d_model, jcfg.moe, getattr(jnp, dtype))
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype),
        jparam.init_params(jax.random.PRNGKey(2), jspecs))
    tp = tparam.convert_like(_np(jp), tmoe.moe_specs(
        tcfg.d_model, tcfg.moe, cdt), CPU)
    assert tp["router"].dtype == torch.float32
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jout, jaux = jmoe.moe_block(jp, jx, jcfg.moe,
                                compute_dtype=getattr(jnp, dtype),
                                rules=RULES)
    tout, taux = tmoe.moe_block(tp, tparam.from_numpy(jx, cdt, CPU),
                                tcfg.moe, compute_dtype=cdt)
    assert tout.shape == (B, S, tcfg.d_model) and tout.dtype == cdt
    _close(tout, jout, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


# --------------------------------------------------------- transformer ----

@pytest.mark.parametrize("jimpl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch, jimpl):
    """float32 only: in bf16 the two packages' hidden states part by an
    ulp after the first attention (summation order), enough to move a
    router's near-tie, and one moved choice moves the output by a whole
    expert's share (0.18 relative L2 here).  The bf16 MoE block is held on
    identical inputs in ``test_moe_block_matches_jax``."""
    dtype = "float32"
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype)
    tok = _tokens()
    jh, jaux = jtr.forward(jcfg, jparams, jnp.asarray(tok), RULES,
                           impl=jimpl)
    th, taux = ttr.forward(tcfg, tparams, torch.from_numpy(tok))
    assert th.shape == (B, S, tcfg.d_model)
    _close(th, jh, dtype)
    # the summed load-balancing loss of both layers
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jl, _ = jtr.prefill(jcfg, jparams, jnp.asarray(tok), RULES, impl=jimpl)
    tl, th2 = ttr.prefill(tcfg, tparams, torch.from_numpy(tok))
    assert tl.shape == (B, 1, tcfg.vocab)
    assert torch.equal(th2, th)
    _close(tl, jl, dtype)


@pytest.mark.parametrize("jimpl", ["xla", "flash_decode_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, jimpl):
    """Decode groups are the batch: two tokens a step at capacity 1, so
    a row whose expert the other row took first drops that assignment,
    in both packages alike (float32, as the forward above)."""
    dtype = "float32"
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype)
    assert tmoe.capacity(B, tcfg.moe) == 1
    tok = _tokens(seed=2)
    jcache = jtr.init_cache(jcfg, B, SMAX)
    tcache = ttr.init_cache(tcfg, B, SMAX, CPU)
    for pos in range(STEPS):
        t = tok[:, pos:pos + 1]
        jl, jcache = jtr.decode_step(jcfg, jparams, jnp.asarray(t), jcache,
                                     pos, RULES, impl=jimpl)
        tl, tcache = ttr.decode_step(tcfg, tparams, torch.from_numpy(t),
                                     tcache, pos)
        assert tl.shape == (B, 1, tcfg.vocab)
        _close(tl, jl, dtype)
    _close(tcache["layer_1"]["k"], np.asarray(jcache["k"][1]), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill_without_drops(arch):
    """With capacity_factor = n_experts / top_k every group's capacity
    holds all its tokens, so nothing drops and decode logits equal the
    prefill logits position by position (at the published factor the
    two group differently and drop different tokens, by design)."""
    _, tcfg, _, tparams = _pair(arch)
    m = tcfg.moe
    ncfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    assert tmoe.capacity(m.group_size, ncfg.moe) >= m.group_size
    assert tmoe.capacity(B, ncfg.moe) >= B
    tok = torch.from_numpy(_tokens(seed=3))
    h, _ = ttr.forward(ncfg, tparams, tok)
    want = ttr.logits(ncfg, tparams, h)
    cache = ttr.init_cache(ncfg, B, SMAX, CPU)
    for pos in range(STEPS):
        got, cache = ttr.decode_step(ncfg, tparams, tok[:, pos:pos + 1],
                                     cache, pos)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, pos].numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_params_takes_scanned_and_unscanned_moe_trees(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    stacked = jparams["layers"]["moe"]
    for i in range(tcfg.n_layers):
        lp = tparams["layers"][f"layer_{i}"]["moe"]
        for name in ("router", "wg", "wu", "wd"):
            np.testing.assert_array_equal(lp[name].numpy(),
                                          np.asarray(stacked[name][i]))
        assert ("shared" in lp) == bool(tcfg.moe.n_shared)
    ujcfg, _ = _cfgs(arch, scan_layers=False)
    uj = jparam.init_params(jax.random.PRNGKey(3), jtr.param_specs(ujcfg))
    assert "layer_1" in uj["layers"]
    ut = ttr.convert_params(_np(uj), tcfg, CPU)
    tok = _tokens(seed=6)
    jh, _ = jtr.forward(ujcfg, uj, jnp.asarray(tok), RULES)
    _close(ttr.forward(tcfg, ut, torch.from_numpy(tok))[0], jh, "float32")


def test_init_params_follows_the_reference_rules():
    """Expert kernels draw with std 1 / sqrt(their middle axis): d^-0.5
    for ``wg`` / ``wu``, ff^-0.5 for ``wd`` (not (E d)^-0.5); the router
    is float32 in a bf16 model, std d^-0.5."""
    _, tcfg = _cfgs("deepseek-moe-16b", "bfloat16")
    p = ttr.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    lp = p["layers"]["layer_0"]["moe"]
    assert lp["router"].dtype == torch.float32
    assert lp["wg"].dtype == torch.bfloat16
    d, ff = tcfg.d_model, tcfg.moe.d_ff_expert
    for name, fan_in in (("router", d), ("wg", d), ("wu", d), ("wd", ff)):
        assert abs(float(lp[name].float().std()) - fan_in ** -0.5) < 0.01, \
            name
    assert abs(float(lp["shared"]["down"]["kernel"].float().std())
               - ff ** -0.5) < 0.01
    # at full width: the spec's std, against the JAX package's rule
    full = ttr.param_specs(get("deepseek-moe-16b"))["layers"]["layer_0"]
    for name, fan_in in (("router", 2048), ("wg", 2048), ("wu", 2048),
                         ("wd", 1408)):
        assert math.isclose(tparam._std(full["moe"][name]), fan_in ** -0.5)
    assert full["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------- int8 ----

def _int8(arch, dtype="float32", scan=True):
    jcfg, tcfg, jp, tp = _pair(arch, dtype, scan_layers=scan)
    jq = dataclasses.replace(jcfg, quant_weights=True)
    tq = dataclasses.replace(tcfg, quant_weights=True)
    jqp = jquantize.quantize_params(jtr.param_specs(jq), jp)
    tqp = tquantize.quantize_params(ttr.param_specs(tq), tp)
    return jcfg, jq, tcfg, tq, jp, jqp, tp, tqp


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_moe_values_bit_equal_jax(arch, dtype, scan):
    """``quantize_params`` on MoE specs: expert kernels (E, in, out) reduce
    over their middle axis to (E, out) scales; values and scales equal the
    JAX package's bit for bit, the float32 router stays float32."""
    *_, tq, _, jqp, _, tqp = _int8(arch, dtype, scan)
    want = ttr.convert_params(_np(jqp), tq, CPU)
    got_leaves = dict(zip(_paths(tqp), tparam.leaves(tqp)))
    for path, w in zip(_paths(want), tparam.leaves(want)):
        g = got_leaves[path]
        assert g.dtype == w.dtype and torch.equal(g, w), path
    lp = tqp["layers"]["layer_1"]["moe"]
    e, d, ff = tq.moe.n_experts, tq.d_model, tq.moe.d_ff_expert
    assert lp["wg"]["q"].shape == (e, d, ff)
    assert lp["wg"]["scale"].shape == (e, ff)
    assert lp["wd"]["scale"].shape == (e, d)
    assert lp["wd"]["q"].dtype == torch.int8
    assert int(lp["wu"]["q"].abs().amax(1).min()) == 127
    assert lp["router"].dtype == torch.float32


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def test_quantizer_takes_expert_axes_from_the_spec():
    """The spec names the reduce axis; a scale that does not match the
    kernel without it raises rather than being guessed from sizes."""
    q_spec = tparam.spec((4, 6, 6), dtype=torch.int8, init="zeros",
                         fan_in_axes=(1,))
    k = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 6, 6)).astype(np.float32))
    q, s = tquantize._quantize_kernel(k, q_spec, tparam.spec((4, 6)))
    assert torch.equal(s, k.abs().amax(1) / 127.0 + 1e-12)
    with pytest.raises(ValueError, match="fan-in axes"):
        tquantize._quantize_kernel(k, q_spec, tparam.spec((6, 6)))


@pytest.mark.parametrize("jimpl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_moe_forward_matches_jax(arch, jimpl):
    jcfg, jq, tcfg, tq, jp, jqp, tp, tqp = _int8(arch)
    tok = _tokens(seed=5)
    jh, jaux = jtr.forward(jq, jqp, jnp.asarray(tok), RULES, impl=jimpl)
    th, taux = ttr.forward(tq, tqp, torch.from_numpy(tok))
    _close(th, jh, "float32")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # int8 tracks fp
    fl, _ = ttr.prefill(tcfg, tp, torch.from_numpy(tok))
    ql, _ = ttr.prefill(tq, tqp, torch.from_numpy(tok))
    assert np.corrcoef(fl.numpy().ravel(), ql.numpy().ravel())[0, 1] > 0.99
