"""Cell planning and the meta-device dry run (``api.py``,
``launch/hlo_analysis.py``, ``launch/dryrun.py``) against the JAX
package's.

``plan_cell`` on the unit mesh gives the JAX plan's argument shapes and
dtypes and its in / out specs, for the 40 cells of ``all_cells()`` and
the detector's 3; ``model_flops``, ``estimate_activation_bytes`` and the
``RooflineTerms`` properties are bit-equal on the same inputs.  The JAX
plans are taken unscanned (``scan_layers=False``), the form of the port's
trees (a list index ``i`` reads as ``layer_{i}``).  The dry run's count
of a reduced step equals ``FlopCounterMode`` over the same step run for
real, the secant over depths 1 and 2 equals the direct count, and the
``python -m repro_torch.launch.dryrun`` CLI plans the JAX tests' cells
with ``0 failed``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.config import HardwareConfig as JHardware
from repro.configs.reduced import reduce_arch as jreduce_arch
from repro.launch import hlo_analysis as jhlo
from repro.launch.mesh import make_unit_mesh as jmake_unit_mesh
from repro.models import transformer as jtransformer
from repro.param import init_params as jinit_params
from repro.sharding import ShardingConfig as JShardingConfig
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import param as tparam
from repro_torch.config import ShapeConfig
from repro_torch.configs.reduced import reduce_arch, reduce_shape
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     make_unit_mesh)
from repro_torch.models import transformer as ttransformer
from repro_torch.sharding import PartitionSpec, ShardingConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CELLS = [(a, s.name) for a, s in tconfigs.all_cells()] + [
    ("tangram-detector", s.name)
    for s in tconfigs.arch_spec("tangram-detector").shapes]


def _flat(tree, prefix=()):
    """{path: leaf}; a list index reads as ``layer_{i}``, a tuple index as
    ``arg{i}``; PartitionSpecs, ShardingS and None are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (f"layer_{i}",)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (f"arg{i}",)))
        return out
    return {prefix: tree}


def _cell(arch, shape_name, jax_side):
    reg = jconfigs if jax_side else None
    spec = tconfigs.arch_spec(arch)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    ov = spec.override(shape_name)
    if jax_side:
        model = reg.get(arch).model
        if hasattr(model, "scan_layers"):
            model = dataclasses.replace(model, scan_layers=False)
        rules = JShardingConfig.make(fsdp=ov.fsdp,
                                     sequence_parallel=ov.sequence_parallel,
                                     act_seq=ov.act_seq,
                                     extra=ov.extra_rules).rules
        shape = next(s for s in reg.get(arch).shapes if s.name == shape_name)
    else:
        model = spec.model
        rules = ShardingConfig.make(fsdp=ov.fsdp,
                                    sequence_parallel=ov.sequence_parallel,
                                    act_seq=ov.act_seq,
                                    extra=ov.extra_rules).rules
    if ov.remat_policy and hasattr(model, "remat_policy"):
        model = dataclasses.replace(model, remat_policy=ov.remat_policy)
    if ov.quant_weights and hasattr(model, "quant_weights"):
        model = dataclasses.replace(model, quant_weights=True)
    return model, shape, rules, ov


def _spec(x):
    return None if x is None else tuple(getattr(x, "spec", x))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_plan_cell_equals_jax_on_the_unit_mesh(arch, shape_name):
    jm, js, jr, ov = _cell(arch, shape_name, True)
    tm, ts, tr, _ = _cell(arch, shape_name, False)
    jplan = japi.plan_cell(jm, js, jmake_unit_mesh(), jr,
                           accum_steps=ov.accum_steps)
    tplan = tapi.plan_cell(tm, ts, make_unit_mesh(), tr,
                           accum_steps=ov.accum_steps)
    assert (tplan.kind, tplan.notes, tplan.scale) == \
        (jplan.kind, jplan.notes, jplan.scale)
    assert (tplan.n_params, tplan.n_active_params) == \
        (jplan.n_params, jplan.n_active_params)
    targs, jargs = _flat(tplan.args), _flat(jplan.args)
    assert set(targs) == set(jargs)
    for k, t in targs.items():
        j = jargs[k]
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            (tuple(j.shape), str(j.dtype)), k
    tin, jin = _flat(tplan.in_shardings), _flat(jplan.in_shardings)
    assert {k: _spec(v) for k, v in tin.items()} == \
        {k: _spec(v) for k, v in jin.items()}
    tout, jout = _flat(tplan.out_shardings), _flat(jplan.out_shardings)
    assert {k: _spec(v) for k, v in tout.items()} == \
        {k: _spec(v) for k, v in jout.items()}


@pytest.mark.parametrize("mesh_sizes", [(1, 1), (2, 4), (16, 16)])
def test_model_flops_and_activation_bytes_equal_jax(mesh_sizes):
    data, model_size = mesh_sizes
    for arch, shape_name in CELLS:
        jm, js, _, ov = _cell(arch, shape_name, True)
        tm, ts, _, _ = _cell(arch, shape_name, False)
        kind = "train" if ts.kind == "cls" else ts.kind
        for k in {kind, ts.kind}:
            assert hlo_analysis.model_flops(
                tm.n_params, tm.n_active_params, ts, k, tm) == \
                jhlo.model_flops(jm.n_params, jm.n_active_params, js, k, jm)
            for act_seq in (False, True):
                assert hlo_analysis.estimate_activation_bytes(
                    tm, ts, k, data, model_size, ov.accum_steps,
                    act_seq=act_seq) == jhlo.estimate_activation_bytes(
                    jm, js, k, data, model_size, ov.accum_steps,
                    act_seq=act_seq), (arch, shape_name, k)


def test_roofline_terms_equal_jax():
    rng = np.random.default_rng(3)
    hw = JHardware()
    for _ in range(50):
        f, b, c = (float(x) for x in rng.uniform(0, 1e15, 3))
        kw = dict(arch="a", shape="s", mesh="m", flops_per_device=f,
                  bytes_per_device=b, collective_bytes_per_device=c,
                  peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                  model_flops_global=float(rng.uniform(0, 1e17)),
                  chips=int(rng.integers(1, 512)),
                  arg_bytes=int(rng.integers(0, 2**40)),
                  temp_bytes=int(rng.integers(0, 2**30)),
                  analytic_act_bytes=float(rng.uniform(0, 1e11)),
                  notes="n")
        t = hlo_analysis.RooflineTerms(nvlink_bw=hw.ici_bw, **kw)
        j = jhlo.RooflineTerms(ici_bw=hw.ici_bw, **kw)
        for prop in ("hbm_estimate", "t_compute", "t_memory",
                     "t_collective", "bottleneck", "useful_flops_ratio",
                     "roofline_fraction"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.row() == j.row()


@pytest.mark.parametrize("batch", [1, 8])
def test_dry_run_counts_equal_a_real_run(batch):
    """The detector's serve step (reduced, bf16) on the unit mesh: the dry
    run's FLOPs equal ``FlopCounterMode`` over the same step run for real
    on CPU tensors, and its argument bytes the real parameters and input
    (the check the card makes at full width)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(reduce_arch(tconfigs.get("tangram-detector")),
                              canvas=256, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = ShapeConfig(f"serve_c{batch}", "serve", img_res=256,
                        global_batch=batch)
    mesh = make_unit_mesh()
    plan = tapi.plan_cell(cfg, shape, mesh, ShardingConfig.make().rules)
    counted = dryrun.count_metrics(plan, mesh)
    params = tparam.init_params(tapi.param_specs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
    x = torch.rand(batch, cfg.canvas, cfg.canvas, 3)
    with FlopCounterMode(display=False) as fc:
        obj, boxes = plan.step_fn(params, x)
    assert counted["flops"] == fc.get_total_flops() > 0
    assert counted["args"] == hlo_analysis.local_bytes((params, x))
    assert counted["coll"] == 0
    assert counted["out"] == hlo_analysis.local_bytes((obj, boxes))


def test_step_counter_reads_collectives_and_views():
    """A sharded product and its all-reduce, per device: the local FLOPs,
    the all-reduce's output bytes, and no bytes for a view."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.compat import shardingx
    mesh = make_test_mesh()
    dm = shardingx.device_mesh(mesh)
    a = DTensor.from_local(torch.empty(8, 16, device="meta"), dm,
                           [Shard(0), Shard(1)], run_check=False)
    b = DTensor.from_local(torch.empty(16, 32, device="meta"), dm,
                           [Replicate(), Shard(0)], run_check=False)
    with hlo_analysis.StepCounter() as c:
        y = (a @ b).redistribute(dm, [Shard(0), Replicate()])
        y.to_local().view(-1)
    assert c.flops == 2 * 8 * 16 * 32
    assert c.coll.count_by_kind["all-reduce"] == 1
    assert c.coll.bytes_by_kind["all-reduce"] == 8 * 32 * 4
    assert y.to_local().shape == (8, 32)
    assert c.bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4


def test_secant_over_depths_equals_the_direct_count():
    """XLA counts a scanned layer once, so the JAX dry run takes a secant
    over depths 1 and 2; the port's eager run counts every layer, and the
    secant lands on its direct count exactly."""
    mesh = make_test_mesh()
    model = dataclasses.replace(reduce_arch(tconfigs.get("minitron-4b")),
                                n_layers=4)
    rules = ShardingConfig.make(fsdp=True).rules
    for shape in (tconfigs.arch_spec("minitron-4b").shapes[0],
                  tconfigs.arch_spec("minitron-4b").shapes[1]):
        shape = reduce_shape(model, shape)
        direct = dryrun.count_metrics(
            tapi.plan_cell(model, shape, mesh, rules), mesh)
        u = [dryrun.count_metrics(tapi.plan_cell(
            model, shape, mesh, rules, dryrun=True, depth_override=d),
            mesh) for d in (1, 2)]
        for key in ("flops", "bytes", "coll"):
            secant = u[0][key] + (model.n_layers - 1) * (u[1][key] -
                                                         u[0][key])
            assert secant == direct[key] > 0, (shape.name, key)


@pytest.mark.parametrize("arch", ["minitron-4b", "efficientnet-b7"])
def test_cut_depth_keeps_every_width(arch):
    """``dryrun.cut_depth``: two layers (an EfficientNet at most two blocks
    a stage, each block one of the full model's), every other field as
    the full config has it."""
    from repro_torch.models import efficientnet as teff
    model = tconfigs.get(arch)
    cut = dryrun.cut_depth(model, 2)
    if hasattr(model, "n_layers"):
        assert cut.n_layers == 2
        assert dataclasses.replace(cut, n_layers=model.n_layers) == model
    else:
        full, few = teff.block_args(model), teff.block_args(cut)
        assert max(cut.scaled_repeats(r) for _, _, r, _, _ in
                   model.STAGES) == 2 and len(few) < len(full)
        assert all(b in full for b in few)
        assert dataclasses.replace(cut, depth_mult=model.depth_mult) == model


def test_dryrun_job_counts_a_cell_cut_to_depth():
    """A dry-run job with a depth counts the cell with its model cut
    (:func:`dryrun.cut_depth`): no failure, and the per-layer FLOPs
    scale the cut count to the full one exactly."""
    job = ("vit-s16", "serve_b1", "test", False, "16x16-test", True)
    rows = [dryrun._job(*job, depth)[0] for depth in (1, 2, None)]
    assert all(row is not None for row in rows)
    f1, f2, full = (row["flops_per_device"] for row in rows)
    assert 0 < f1 < f2 < full == f1 + 11 * (f2 - f1)


_SEED_PROBE = """
import json, sys
sys.path[:0] = [{src!r}]
from repro_torch.launch import dryrun
row, text, fail = dryrun._job({arch!r}, {shape!r}, "production", False,
                              "16x16", True, 2)
assert fail is None, text
print(json.dumps({{k: row[k] for k in ("flops_per_device",
                  "bytes_per_device", "collective_bytes_per_device",
                  "arg_bytes")}}))
"""


@pytest.mark.parametrize("arch,shape", [("deit-b", "serve_b1")])
def test_dryrun_counts_do_not_depend_on_the_hash_seed(arch, shape):
    """A cell counts the same FLOPs, bytes, collective bytes and argument
    bytes in processes under string-hash seeds 0 and 7.  DTensor's sharding
    propagation tries candidate placements in the order of a ``set`` (so
    of the seed) and allocates ``meta`` tensors for each; the counter
    leaves that planning out (``hlo_analysis._planning``), where it once
    counted 117,495,918 bytes a device under seed 0 and 115,671,150 under
    seed 7 here."""
    code = _SEED_PROBE.format(src=os.path.abspath(SRC), arch=arch,
                              shape=shape)
    counts = []
    for seed in ("0", "7"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = seed
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, env=env,
                              timeout=240)
        assert proc.returncode == 0, proc.stderr
        counts.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert counts[0] == counts[1]
    assert counts[0]["bytes_per_device"] > 0


def test_reduced_mistral_prefill_equals_jax():
    """``mistral-large-123b`` resolves in the port; its reduced config's
    prefill equals JAX's on the JAX weights at 1e-4."""
    jcfg = jreduce_arch(jconfigs.get("mistral-large-123b").model)
    tcfg = reduce_arch(tconfigs.get("mistral-large-123b"))
    assert tcfg.name == jcfg.name == "mistral-large-123b"
    jparams = jinit_params(jax.random.PRNGKey(0),
                           jtransformer.param_specs(jcfg))
    tparams = ttransformer.convert_params(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 48))
    jlogits, jh = jtransformer.prefill(jcfg, jparams, jnp.asarray(tokens),
                                       {})
    tlogits, th = ttransformer.prefill(tcfg, tparams,
                                       torch.from_numpy(tokens),
                                       impl="xla")
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


def _dryrun(*args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, env=env, timeout=timeout)


@pytest.mark.parametrize("arch,shape", [
    ("vit-s16", "serve_b128"), ("dit-s2", "gen_fast"),
    ("minitron-4b", "decode_32k")])
def test_dryrun_cli_on_the_test_mesh(arch, shape, tmp_path):
    out = tmp_path / "r.json"
    r = _dryrun("--mesh", "test", "--quick", "--arch", arch, "--shape",
                shape, "--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 cells OK, 0 failed" in r.stdout
    row = json.load(open(out))["results"][0]
    assert row["flops_per_device"] > 0 and row["mesh"] == "16x16-test"
    assert "direct" in row["notes"]


def test_dryrun_cli_multi_pod_with_json(tmp_path):
    out = tmp_path / "r.json"
    r = _dryrun("--mesh", "test", "--quick", "--arch", "vit-s16",
                "--shape", "serve_b128", "--multi-pod", "--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.load(open(out))
    assert len(data["results"]) == 1 and data["failures"] == []
    row = data["results"][0]
    assert row["mesh"].startswith("2x") and row["flops_per_device"] > 0
    assert row["chips"] == 8


def test_dryrun_cli_secant_note_without_quick():
    r = _dryrun("--mesh", "test", "--arch", "vit-s16", "--shape",
                "serve_b1")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "secant(L=12, scale=1) flops 1.0000x direct" in r.stdout
    assert "(3 meta runs" in r.stdout


def test_dryrun_mistral_train_on_the_production_mesh(tmp_path):
    """The 123B model's train step (4 microbatches of 64 x 4096, FSDP,
    sequence-sharded activations) on the 16 x 16 mesh, its 88 layers cut
    to 2 (``--depth 2``, ``dryrun.cut_depth``, as ``chip_smoke.py`` phase
    11(c) runs it): every op of the cell still plans and counts, where
    the full depth takes over 100 s on one free core."""
    out = tmp_path / "r.json"
    r = _dryrun("--quick", "--depth", "2", "--arch", "mistral-large-123b",
                "--shape", "train_4k", "--json", str(out), timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 cells OK, 0 failed" in r.stdout
    row = json.load(open(out))["results"][0]
    assert row["flops_per_device"] > 0 and row["chips"] == 256
    assert row["collective_bytes_per_device"] > 0


def test_grad_rs_lays_gradients_out_as_the_params():
    """``plan_cell(grad_rs=True)`` (ZeRO-2): each gradient is constrained
    to its FSDP-sharded parameter's layout.  Under DTensor the backward
    pass already reduce-scatters the FSDP-sharded weights' gradients (the
    same reduce-scatter bytes either way); the constraint reduces the
    gradients still pending as partial sums (the replicated norms') at
    once, and leaves every gradient in its parameter's layout."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.compat import shardingx
    from repro_torch.training.train_state import (constrain_grads,
                                                  value_and_grad)
    mesh = make_test_mesh()
    model = reduce_arch(tconfigs.get("minitron-4b"))
    shape = reduce_shape(model, tconfigs.arch_spec("minitron-4b").shapes[0])
    rules = ShardingConfig.make(fsdp=True).rules
    counts = {}
    for grad_rs in (False, True):
        plan = tapi.plan_cell(model, shape, mesh, rules, grad_rs=grad_rs)
        counts[grad_rs] = dryrun.count_metrics(plan, mesh)
    rs = [c["coll_by_kind"]["reduce-scatter"] for c in counts.values()]
    assert rs[0] == rs[1] > 0
    assert counts[True]["flops"] == counts[False]["flops"]
    args = tapi.abstract_args(plan, mesh)
    pspecs = tparam.param_pspecs(tapi.param_specs(model), rules, mesh)
    with shardingx.use_mesh(mesh, rules), implicit_replication():
        _, grads = value_and_grad(tapi._loss_fn(model), args[0], args[2])
        grads = constrain_grads(grads, pspecs)
    for g, p in zip(tparam.sorted_leaves(grads),
                    tparam.sorted_leaves(args[0])):
        assert g.placements == p.placements
