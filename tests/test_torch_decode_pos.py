"""The decode step at a device position: ``pos`` a 0-d int32 tensor, as
the JAX step takes a traced ``jnp.int32`` (its Pallas K7 reads it from
SMEM), so that one step, jitted there and captured in a CUDA graph here,
serves every position.

On the CPU the port's ``decode_step`` at ``torch.tensor(0)`` and then
``torch.tensor(1)`` on one cache is held against ``jax.jit(decode_step)``
at ``jnp.int32(0)`` and ``jnp.int32(1)`` (``tests/test_arch_smoke.py``'s
decode case), for every reduced LM, with the JAX parameters passed
through ``convert_params``; the JAX side runs its plain attention and its
K7 in interpret mode, the port K7's plain version.  The int8 KV cache and
the masked write the same way.  A tensor ``pos`` gives the host int's
logits and caches bit for bit.  ``api.plan_decode``'s step writes the row
at the position it is given, and the decode cells' dry-run FLOPs are what
they were when the step decoded at the cache's last position.

Tolerances, as ``tests/test_torch_transformer.py`` and
``tests/test_torch_moe.py`` hold decode: 1e-4 elementwise in float32
(summation order differs between XLA and PyTorch's CPU matmuls); an int8
cache's values within one quantization step on under 1% of entries (the
K projection's last ulp moves a rounding) and its scales within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import param as jparam
from repro.configs.reduced import reduce_arch as jreduce
from repro.models import transformer as jtr
from repro.sharding import ShardingConfig
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import param as tparam
from repro_torch.configs.reduced import reduce_arch as treduce
from repro_torch.configs.reduced import reduce_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_unit_mesh
from repro_torch.models import transformer as ttr

CPU = torch.device("cpu")
RULES = ShardingConfig.make().rules
B, SMAX = 2, 64
TOL = 1e-4
LM_ARCHS = ("minitron-4b", "deepseek-moe-16b", "llama4-scout-17b-a16e",
            "mistral-large-123b")


def _pair(arch, **kw):
    """The reduced arch in float32 in both packages, JAX parameters
    (perturbed, so the norm scales are exercised off 1) and the port's
    conversion of them."""
    jcfg = dataclasses.replace(jreduce(jconfigs.get(arch).model),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(treduce(tconfigs.get(arch)),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)
    jparams = jparam.init_params(jax.random.PRNGKey(0),
                                 jtr.param_specs(jcfg))
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, x.dtype),
        jparams)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, ttr.convert_params(np_tree, tcfg, CPU)


def _tokens(cfg, seed, steps=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
            for _ in range(steps)]


def _jitted_and_port(arch, jimpl="xla", seed=1, **kw):
    """Two decode steps on one cache: the JAX step jitted once and called
    at ``jnp.int32(0)`` then ``jnp.int32(1)``, the port's at
    ``torch.tensor(0)`` then ``torch.tensor(1)``.  Returns the per-step
    logits of both and both final caches."""
    jcfg, tcfg, jparams, tparams = _pair(arch, **kw)
    jcache = jtr.init_cache(jcfg, B, SMAX)
    tcache = ttr.init_cache(tcfg, B, SMAX, CPU)
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(
        jcfg, p, t, c, pos, RULES, impl=jimpl))
    out = []
    for pos, tok in enumerate(_tokens(tcfg, seed)):
        jl, jcache = step(jparams, jnp.asarray(tok), jcache, jnp.int32(pos))
        tl, tcache = ttr.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                     tcache,
                                     torch.tensor(pos, dtype=torch.int32))
        assert tl.shape == (B, 1, tcfg.vocab)
        out.append((tl, jl))
    return tcfg, out, tcache, jcache


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


def _same_cache(tcfg, tcache, jcache, int8_steps=False):
    """The port's cache, layer by layer, holds the JAX cache's rows."""
    for i in range(tcfg.n_layers):
        for key, leaf in tcache[f"layer_{i}"].items():
            got, want = leaf.numpy(), np.asarray(jcache[key][i])
            if got.dtype == np.int8:
                assert int8_steps
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
                assert (got != want).mean() < 0.01
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("jimpl", ["xla", "flash_decode_interpret"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_at_device_positions_matches_jitted_jax(arch, jimpl):
    """Every reduced LM: two decode steps at device positions 0 and 1 on
    one cache against the JAX step jitted once (its plain attention, and
    its K7 in interpret mode reading the traced position)."""
    tcfg, out, tcache, jcache = _jitted_and_port(arch, jimpl)
    for tl, jl in out:
        _close(tl, jl)
    _same_cache(tcfg, tcache, jcache)
    # the port wrote rows 0 and 1 and nothing past them
    k = tcache["layer_0"]["k"]
    assert k[:, :2].abs().sum() > 0 and not k[:, 2:].any()


@pytest.mark.parametrize("form", [dict(quant_kv=True),
                                  dict(cache_update="masked"),
                                  dict(quant_kv=True,
                                       cache_update="masked")],
                         ids=["int8_kv", "masked", "int8_kv_masked"])
@pytest.mark.parametrize("arch", ["minitron-4b", "deepseek-moe-16b"])
def test_cache_forms_at_device_positions_match_jitted_jax(arch, form):
    """The int8 KV cache (``tests/test_quantize.py``'s case, values and
    scales written at the device position) and the masked write, each
    against the jitted JAX step at ``jnp.int32`` positions."""
    tcfg, out, tcache, jcache = _jitted_and_port(arch, seed=5, **form)
    for tl, jl in out:
        _close(tl, jl)
    _same_cache(tcfg, tcache, jcache, int8_steps="quant_kv" in form)


@pytest.mark.parametrize("form", [{}, dict(cache_update="masked"),
                                  dict(quant_kv=True)],
                         ids=["dus", "masked", "int8_kv"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_tensor_pos_equals_host_int(arch, form):
    """Four steps at a 0-d int32 ``pos`` and at the host int, on two
    caches: logits and caches bit-equal; ``"dus"`` writes the given
    cache in place either way, ``"masked"`` leaves it as it was."""
    cfg = dataclasses.replace(treduce(tconfigs.get(arch)), **form)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    caches = [ttr.init_cache(cfg, B, SMAX, CPU) for _ in range(2)]
    for pos, tok in enumerate(_tokens(cfg, 3, steps=4)):
        tok = torch.from_numpy(tok)
        outs = []
        for i, p in enumerate((pos, torch.tensor(pos, dtype=torch.int32))):
            logits, new = ttr.decode_step(cfg, params, tok, caches[i], p)
            assert (new is caches[i]) == (cfg.cache_update != "masked")
            caches[i] = new
            outs.append(logits)
        assert torch.equal(outs[0], outs[1])
    for name, layer in caches[0].items():
        for key, leaf in layer.items():
            assert torch.equal(leaf, caches[1][name][key])


def test_decode_pos_takes_integer_tensors_and_refuses_the_rest():
    """An int64 tensor ``pos`` decodes as the int32 one; a float, a
    vector or a bool ``pos`` raises, naming what it got."""
    cfg = treduce(tconfigs.get("minitron-4b"))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    tok = torch.ones((B, 1), dtype=torch.int64)
    got = [ttr.decode_step(cfg, params, tok,
                           ttr.init_cache(cfg, B, SMAX, CPU), p)[0]
           for p in (3, torch.tensor(3), torch.tensor(3, dtype=torch.int32))]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    for bad in (torch.tensor(3.0), torch.tensor([3]), torch.tensor(True)):
        with pytest.raises(TypeError, match="0-d integer tensor"):
            ttr.decode_step(cfg, params, tok,
                            ttr.init_cache(cfg, B, SMAX, CPU), bad)


def test_device_pos_past_the_cache_is_clamped_as_xla_clamps():
    """A device ``pos`` is not checked on the host (that would sync it).
    Past the cache, the in-place write clamps its row into [0, Smax) as
    the JAX ``dynamic_update_slice`` clamps its start, while RoPE rotates
    by the position given, as the JAX step does: logits and cache equal
    the jitted JAX step's at ``jnp.int32(Smax + 5)``.  A host int past
    the cache raises."""
    jcfg, tcfg, jparams, tparams = _pair("minitron-4b", cache_update="dus")
    tok = _tokens(tcfg, 7, steps=1)[0]
    jl, jcache = jax.jit(lambda p, t, c, pos: jtr.decode_step(
        jcfg, p, t, c, pos, RULES))(jparams, jnp.asarray(tok),
                                    jtr.init_cache(jcfg, B, SMAX),
                                    jnp.int32(SMAX + 5))
    tcache = ttr.init_cache(tcfg, B, SMAX, CPU)
    tl, tcache = ttr.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                 tcache,
                                 torch.tensor(SMAX + 5, dtype=torch.int32))
    _close(tl, jl)
    _same_cache(tcfg, tcache, jcache)
    k = tcache["layer_0"]["k"]
    assert k[:, -1].abs().sum() > 0 and not k[:, :-1].any()
    with pytest.raises(IndexError):
        ttr.decode_step(tcfg, tparams, torch.from_numpy(tok), tcache,
                        SMAX + 5)


@pytest.mark.parametrize("arch", ["minitron-4b", "deepseek-moe-16b"])
def test_plan_decode_step_writes_the_row_at_its_pos(arch):
    """``api.plan_decode``'s step on real CPU tensors (the reduced
    ``decode_32k``, the unit mesh): at device positions 5 and 100 it
    writes the new K / V row there and nowhere else, and its logits are
    ``decode_step``'s at the host int."""
    model = treduce(tconfigs.get(arch))
    spec = next(s for s in tconfigs.arch_spec(arch).shapes
                if s.name == "decode_32k")
    shape = reduce_shape(model, spec)
    plan = tapi.plan_cell(model, shape, make_unit_mesh(), RULES)
    params = tparam.init_params(tapi.param_specs(model),
                                torch.Generator().manual_seed(0), "cpu")
    b, s = shape.global_batch, shape.seq_len
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.vocab, size=(b, 1)))
    for pos in (5, 100):
        cache = ttr.init_cache(model, b, s, CPU)
        logits, cache = plan.step_fn(params, tok, cache,
                                     torch.tensor(pos, dtype=torch.int32))
        for layer in cache.values():
            for leaf in (layer["k"], layer["v"]):
                written = leaf.abs().flatten(2).sum(-1) > 0     # (B, S)
                assert written[:, pos].all()
                assert written.sum() == b
        want, _ = ttr.decode_step(model, params, tok,
                                  ttr.init_cache(model, b, s, CPU), pos,
                                  impl="torch")
        assert torch.equal(logits, want)


@pytest.mark.parametrize("arch,flops", [
    ("minitron-4b", 2164260864), ("mistral-large-123b", 10066329600),
    ("deepseek-moe-16b", 3759144960)])
def test_decode_cells_count_the_same_flops(arch, flops):
    """``decode_32k`` on the production mesh, cut to 2 layers
    (``dryrun.cut_depth``, as ``chip_smoke.py`` phase 11c counts it): at
    its abstract device position the step counts, per device, the FLOPs it
    counted when it decoded at the cache's last position (every position
    attends over the whole masked cache either way)."""
    row, text, fail = dryrun._job(arch, "decode_32k", "production", False,
                                  "16x16", True, 2)
    assert fail is None, text
    assert row["flops_per_device"] == flops
