"""The port's decoder-only LM (prefill, KV-cache decode) against the JAX
package's, on the reduced ``minitron-4b`` (2 layers, d 128, 4 query heads
over 2 KV heads, head_dim 32) with the JAX package's parameters passed
through ``convert_params``.

The JAX side runs the plain XLA attention and both Pallas kernels in
interpret mode (``flash_interpret`` in prefill, ``flash_decode_interpret``
in decode); the port runs on the CPU, where K6 and K7 take their plain
versions.  Tolerances: 1e-4 elementwise in float32 (summation order
differs between XLA and PyTorch's CPU matmuls); 2e-2 relative L2 error in
bfloat16 (see ``_close``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import param as jparam
from repro.configs import minitron_4b as jarch
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import transformer as jtr
from repro.sharding import ShardingConfig
from repro_torch import param as tparam
from repro_torch.config import MoEConfig
from repro_torch.configs import get
from repro_torch.configs.reduced import reduce_arch as treduce
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr

CPU = torch.device("cpu")
B, S, SMAX, STEPS = 2, 64, 64, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RULES = ShardingConfig.make().rules


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jreduce(jarch.ARCH), param_dtype=dtype,
                               compute_dtype=dtype, **kw)
    tcfg = dataclasses.replace(treduce(get("minitron-4b")), param_dtype=dtype,
                               compute_dtype=dtype, **kw)
    return jcfg, tcfg


def _pair(dtype="float32", **kw):
    """JAX params (perturbed, so the norm scales are exercised off 1) and
    the port's conversion of them."""
    jcfg, tcfg = _cfgs(dtype, **kw)
    jparams = jparam.init_params(jax.random.PRNGKey(0),
                                 jtr.param_specs(jcfg))
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype),
        jparams)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, ttr.convert_params(np_tree, tcfg, CPU)


def _tokens(seed=1, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, size=(B, s)).astype(np.int32)


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        return
    # bf16: the relative L2 error of the whole output.  XLA and PyTorch sum
    # a matmul in different orders, so an output near a rounding midpoint
    # lands one bf16 ulp apart; through two layers and a final norm single
    # elements move by a few ulps (up to 0.07 at |x| ~ 3).  In this norm
    # the port's bf16 hidden states are 0.95e-2 from the JAX package's,
    # whose own bf16 run is 1.9e-2 from its float32 run.
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < TOL[dtype], err


def _read_fields(jcfg, tcfg):
    """The JAX config's fields that the port's config has (the port leaves
    out ``scan_layers`` and the TPU-block fields it never reads)."""
    t = dataclasses.asdict(tcfg)
    return {k: v for k, v in dataclasses.asdict(jcfg).items() if k in t}, t


def test_reduced_and_full_configs_match_the_reference():
    j, t = _read_fields(*_cfgs())
    assert t == j
    full_j, full_t = jarch.ARCH, get("minitron-4b")
    j, t = _read_fields(full_j, full_t)
    assert t == j
    assert set(dataclasses.asdict(full_j)) - set(t) == {
        "scan_layers", "flash_block_q", "flash_block_kv"}
    assert full_t.n_params == full_j.n_params
    assert tparam.count_params(ttr.param_specs(full_t)) == \
        jparam.count_params(jtr.param_specs(full_j))
    assert round(full_t.n_params / 1e9, 2) == 5.10


@pytest.mark.parametrize("jimpl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(dtype, jimpl):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    tok = _tokens()
    jh, _ = jtr.forward(jcfg, jparams, jnp.asarray(tok), RULES, impl=jimpl)
    th, aux = ttr.forward(tcfg, tparams, torch.from_numpy(tok))
    assert th.shape == (B, S, tcfg.d_model) and float(aux) == 0.0
    _close(th, jh, dtype)
    jl, _ = jtr.prefill(jcfg, jparams, jnp.asarray(tok), RULES, impl=jimpl)
    tl, th2 = ttr.prefill(tcfg, tparams, torch.from_numpy(tok))
    assert tl.shape == (B, 1, tcfg.vocab)
    assert torch.equal(th2, th)
    _close(tl, jl, dtype)


@pytest.mark.parametrize("jimpl", ["xla", "flash_decode_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype, jimpl):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
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
    # the cache holds what the JAX cache holds (the port writes in place)
    _close(tcache["layer_1"]["k"], np.asarray(jcache["k"][1]), dtype)
    _close(tcache["layer_0"]["v"], np.asarray(jcache["v"][0]), dtype)


def _clone_cache(tree):
    return {name: {k: v.clone() for k, v in layer.items()}
            for name, layer in tree.items()}


@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp", "int8"])
def test_masked_decode_matches_jax_masked(quant_kv):
    """``cache_update="masked"`` in both packages over 8 float32 decode
    steps: logits within 1e-4; each step's new cache equal to the JAX
    one's (float32 within 1e-4; an int8 cache's values within one step
    where the K projection's last ulp moves a rounding, as
    ``tests/test_torch_quantize.py`` holds the in-place write, and its
    scales within 1e-4), every position but ``pos`` carried over bit for
    bit, and the input cache's tensors untouched."""
    jcfg, tcfg, jparams, tparams = _pair(cache_update="masked",
                                         quant_kv=quant_kv)
    tok = _tokens(seed=6)
    jcache = jtr.init_cache(jcfg, B, SMAX)
    tcache = ttr.init_cache(tcfg, B, SMAX, CPU)
    for pos in range(STEPS):
        t = tok[:, pos:pos + 1]
        before = _clone_cache(tcache)
        jl, jcache = jtr.decode_step(jcfg, jparams, jnp.asarray(t), jcache,
                                     pos, RULES, impl="xla")
        tl, new = ttr.decode_step(tcfg, tparams, torch.from_numpy(t),
                                  tcache, pos)
        _close(tl, jl, "float32")
        assert new is not tcache
        for name, layer in tcache.items():
            for key, leaf in layer.items():
                assert torch.equal(leaf, before[name][key])
                assert new[name][key] is not leaf
                keep = torch.arange(SMAX) != pos
                assert torch.equal(new[name][key][:, keep],
                                   leaf[:, keep])
        tcache = new
    for i in range(tcfg.n_layers):
        for key in tcache["layer_0"]:
            got = tcache[f"layer_{i}"][key].numpy()
            want = np.asarray(jcache[key][i])
            if got.dtype == np.int8:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
                assert (got != want).mean() < 0.01
            else:
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_write_equals_dus_bit_for_bit(dtype, quant_kv):
    """The port's two writes over 8 decode steps: logits and caches
    bit-equal (attention sees the same cache either way); ``"dus"``
    returns the input tree itself, ``"masked"`` a new tree."""
    _, tcfg, _, tparams = _pair(dtype, quant_kv=quant_kv)
    tok = torch.from_numpy(_tokens(seed=7))
    caches = {u: ttr.init_cache(tcfg, B, SMAX, CPU) for u in ("dus",
                                                             "masked")}
    for pos in range(STEPS):
        out = {}
        for u in caches:
            cfg = dataclasses.replace(tcfg, cache_update=u)
            out[u], new = ttr.decode_step(cfg, tparams,
                                          tok[:, pos:pos + 1], caches[u],
                                          pos)
            assert (new is caches[u]) == (u == "dus")
            caches[u] = new
        assert torch.equal(out["dus"], out["masked"])
    for name, layer in caches["dus"].items():
        for key, leaf in layer.items():
            assert torch.equal(leaf, caches["masked"][name][key])


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_blend_row_is_the_jax_one_hot_select(dtype):
    """``attention._blend_row`` on the JAX masked update's inputs: the same
    bits as ``jnp.where(arange(Smax) == pos, row, cache)``, values (B, S,
    Kv, D) and int8 scales (B, S, Kv)."""
    rng = np.random.default_rng(8)
    for shape in ((B, SMAX, 2, 32), (B, SMAX, 2)):
        cache = (rng.normal(size=shape) * 50).astype(dtype)
        row = (rng.normal(size=(B, 1) + shape[2:]) * 50).astype(dtype)
        for pos in (0, 17, SMAX - 1):
            sel = (jnp.arange(SMAX) == pos).reshape(
                (1, SMAX) + (1,) * (len(shape) - 2))
            want = np.asarray(jnp.where(sel, row, cache))
            got = tattn._blend_row(torch.from_numpy(cache),
                                   torch.from_numpy(row), pos)
            np.testing.assert_array_equal(got.numpy(), want)


def test_cache_update_resolution():
    """``"auto"`` is ``"masked"`` where the ambient rules shard
    ``kv_seq`` (the sequence-parallel overlay) and ``"dus"`` off a mesh
    or where they do not; the config and the function refuse other
    names."""
    from repro_torch.compat import shardingx
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import ShardingConfig as TShardingConfig
    resolve = tattn.resolve_cache_update
    assert resolve("auto") == "dus"
    assert (resolve("dus"), resolve("masked")) == ("dus", "masked")
    mesh = make_test_mesh()
    with shardingx.use_mesh(mesh, TShardingConfig.make(
            sequence_parallel=True).rules):
        assert resolve("auto") == "masked"
        assert resolve("dus") == "dus"
    with shardingx.use_mesh(mesh, TShardingConfig.make(fsdp=True).rules):
        assert resolve("auto") == "dus"
    with shardingx.use_mesh(mesh):
        assert resolve("auto") == "dus"
    with pytest.raises(ValueError, match="cache_update"):
        resolve("scatter")
    with pytest.raises(ValueError, match="cache_update"):
        _cfgs(cache_update="scatter")
    assert get("minitron-4b").cache_update == jarch.ARCH.cache_update


@pytest.mark.parametrize("variant", [{}, {"fused_qkv": True},
                                     {"tie_embeddings": True}],
                         ids=["split", "fused_qkv", "tied"])
def test_decode_logits_equal_prefill_logits_position_by_position(variant):
    _, tcfg, _, tparams = _pair(**variant)
    tok = torch.from_numpy(_tokens(seed=3))
    h, _ = ttr.forward(tcfg, tparams, tok)
    want = ttr.logits(tcfg, tparams, h)
    cache = ttr.init_cache(tcfg, B, SMAX, CPU)
    first = cache["layer_0"]["k"]
    for pos in range(STEPS):
        got, cache = ttr.decode_step(tcfg, tparams, tok[:, pos:pos + 1],
                                     cache, pos)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, pos].numpy(),
                                   atol=1e-4, rtol=1e-4)
    # the cache tensors are updated in place
    assert cache["layer_0"]["k"] is first
    assert not cache["layer_0"]["k"][:, STEPS:].any()


def test_fused_wqkv_equals_split():
    jcfg, tcfg, jparams, tparams = _pair()
    _, fcfg = _cfgs(fused_qkv=True)
    fused = {k: v for k, v in tparams.items()}
    fused["layers"] = {}
    for name, lp in tparams["layers"].items():
        a = dict(lp["attn"])
        wqkv = torch.cat([a.pop("wq"), a.pop("wk"), a.pop("wv")], dim=1)
        fused["layers"][name] = {**lp, "attn": {"wqkv": wqkv, **a}}
    shapes = tparam.map_tree(lambda s: s.shape, ttr.param_specs(fcfg))
    assert tparam.map_tree(lambda t: tuple(t.shape), fused) == shapes
    tok = torch.from_numpy(_tokens(seed=4))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32))
    attn0 = tparams["layers"]["layer_0"]["attn"]
    for a, b in zip(tattn._qkv(attn0, x, 2, torch.float32),
                    tattn._qkv(fused["layers"]["layer_0"]["attn"], x, 2,
                               torch.float32)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-5)
    split_h, _ = ttr.forward(tcfg, tparams, tok)
    fused_h, _ = ttr.forward(fcfg, fused, tok)
    np.testing.assert_allclose(fused_h.numpy(), split_h.numpy(), atol=1e-5,
                               rtol=1e-5)
    # the JAX package's fused model converts and agrees with it
    jfcfg, _ = _cfgs(fused_qkv=True)
    jf = jparam.init_params(jax.random.PRNGKey(7), jtr.param_specs(jfcfg))
    tf = ttr.convert_params(jax.tree_util.tree_map(np.asarray, jf), fcfg,
                            CPU)
    jh, _ = jtr.forward(jfcfg, jf, jnp.asarray(tok.numpy()), RULES)
    _close(ttr.forward(fcfg, tf, tok)[0], jh, "float32")


def test_convert_params_takes_scanned_and_unscanned_trees():
    jcfg, tcfg, jparams, tparams = _pair()
    stacked = jparams["layers"]
    for i in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            tparams["layers"][f"layer_{i}"]["attn"]["wk"].numpy(),
            np.asarray(stacked["attn"]["wk"][i]))
    ujcfg = dataclasses.replace(jcfg, scan_layers=False)
    uj = jparam.init_params(jax.random.PRNGKey(3), jtr.param_specs(ujcfg))
    assert "layer_1" in uj["layers"]
    ut = ttr.convert_params(jax.tree_util.tree_map(np.asarray, uj), tcfg,
                            CPU)
    tok = _tokens(seed=6)
    jh, _ = jtr.forward(ujcfg, uj, jnp.asarray(tok), RULES)
    _close(ttr.forward(tcfg, ut, torch.from_numpy(tok))[0], jh, "float32")


def test_bf16_convert_keeps_bits():
    _, _, jparams, tparams = _pair("bfloat16")
    w = tparams["lm_head"]["kernel"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        np.asarray(jparams["lm_head"]["kernel"]).view(np.int16))


def test_init_params_follows_the_reference_rules():
    _, tcfg = _cfgs()
    specs = ttr.param_specs(tcfg)
    p = ttr.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert tparam.map_tree(lambda t: tuple(t.shape), p) == \
        tparam.map_tree(lambda s: s.shape, specs)
    lp = p["layers"]["layer_0"]
    # normal: scale / sqrt(prod(fan-in dims)); embed: 0.02; ones / zeros
    assert abs(float(lp["attn"]["wq"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(lp["attn"]["wo"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(lp["mlp"]["down"]["kernel"].std()) - 256 ** -0.5) < 0.01
    assert abs(float(p["embed"]["embedding"].std()) - 0.02) < 0.002
    assert torch.equal(p["ln_f"]["scale"], torch.ones(128))
    again = ttr.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert torch.equal(again["lm_head"]["kernel"], p["lm_head"]["kernel"])


def test_unported_features_raise_naming_their_item():
    """MoE is ported: an MoE config builds and the MoE ids resolve; the
    id whose weights need several cards still names its item."""
    _, tcfg = _cfgs()
    mcfg = dataclasses.replace(tcfg, moe=MoEConfig(n_experts=4, top_k=2))
    assert "moe" in ttr.param_specs(mcfg)["layers"]["layer_0"]
    assert get("deepseek-moe-16b").moe.top_k == 6
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        ttr.init_params(get("mistral-large-123b"), torch.Generator(), "cpu")
    with pytest.raises(KeyError):
        get("gpt-2")
    assert get("tangram-detector").canvas == 1024
