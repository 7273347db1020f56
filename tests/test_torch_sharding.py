"""The port's mesh and logical-axis sharding (``compat/shardingx.py``,
``sharding.py``, ``launch/mesh.py``, ``param.param_pspecs``,
``training/elastic.py``) against the JAX package's.

The rule tables, ``logical_to_spec``, ``divisible_spec`` and every
architecture's full-width ``param_pspecs`` equal JAX's as tuples, on the
JAX tests' stand-in meshes at (1, 1), (2, 4), (16, 16), (2, 2, 2) and
(2, 16, 16), under each overlay.  The port's parameter trees hold one
subtree a layer (lists or ``layer_{i}`` dicts), the JAX package's
unscanned form (``scan_layers=False``): a list index ``i`` is compared
with ``layer_{i}``.  Layouts on the fake process group (``placements``,
``with_logical_constraint``) run in this process: ``device_mesh`` starts
the group on first use.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import sharding as jsharding
from repro.training import elastic as jelastic
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import param as tparam
from repro_torch import sharding as tsharding
from repro_torch.compat import shardingx
from repro_torch.launch import mesh as tmesh
from repro_torch.training import elastic as telastic

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


class FakeMesh:
    """The JAX tests' stand-in: axis names and ``devices.shape``."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


def _overlays(arch):
    """The generic overlays and every override the arch's cells use."""
    out = [dict(), dict(fsdp=True), dict(sequence_parallel=True),
           dict(act_seq=True),
           dict(fsdp=True, sequence_parallel=True, act_seq=True)]
    spec = tconfigs.arch_spec(arch)
    for ov in spec.overrides.values():
        out.append(dict(fsdp=ov.fsdp, sequence_parallel=ov.sequence_parallel,
                        act_seq=ov.act_seq, extra=ov.extra_rules))
    return out


def _flat(tree, prefix=()):
    """{path: leaf}; a list index i reads as ``layer_{i}``."""
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
    return {prefix: tree}


def jax_model(arch):
    """The JAX config, unscanned, the form the port's trees take."""
    model = jconfigs.get(arch).model
    if hasattr(model, "scan_layers"):
        model = dataclasses.replace(model, scan_layers=False)
    return model


def test_rule_tables_equal_jax():
    for name in ("DEFAULT_RULES", "FSDP_OVERLAY", "SEQUENCE_OVERLAY",
                 "ACT_SEQ_OVERLAY"):
        assert dict(getattr(tsharding, name)) == \
            dict(getattr(jsharding, name)), name
    for kw in _overlays("mistral-large-123b") + _overlays("dit-xl2") + \
            _overlays("efficientnet-b7"):
        assert dict(tsharding.ShardingConfig.make(**kw).rules) == \
            dict(jsharding.ShardingConfig.make(**kw).rules), kw
    assert tsharding.merge_rules(None, {"a": "x"}, {"a": "y"}) == \
        jsharding.merge_rules(None, {"a": "x"}, {"a": "y"})


AXES = [("batch", "seq", "embed"), ("batch", "embed"), ("embed", "heads"),
        ("decode_batch", "kv_seq", "kv_heads", "head_dim"),
        ("expert_group", "expert", "capacity", "embed"), ("canvas", None),
        (None, "vocab"), ("layers", "embed", "mlp"), ("stack", "batch")]


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_logical_and_divisible_specs_equal_jax(shape):
    mesh = FakeMesh(shape, MESHES[shape])
    rng = np.random.default_rng(0)
    for kw in _overlays("mistral-large-123b") + _overlays("dit-s2"):
        rules = jsharding.ShardingConfig.make(**kw).rules
        for axes in AXES:
            for m in (None, mesh):
                assert tuple(tsharding.logical_to_spec(axes, rules, m)) == \
                    tuple(jsharding.logical_to_spec(axes, rules, m))
            for _ in range(4):
                dims = [int(d) for d in rng.choice(
                    [1, 2, 3, 4, 8, 12, 16, 40, 64, 96], size=len(axes))]
                assert tuple(tsharding.divisible_spec(dims, axes, rules,
                                                      mesh)) == \
                    tuple(jsharding.divisible_spec(dims, axes, rules, mesh))


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_pspecs_equal_jax(arch, shape):
    """Every full-width architecture: the same leaves, shapes and axes,
    and the same PartitionSpec under every overlay, with the mesh (the
    divisibility fixups) and without."""
    mesh = FakeMesh(shape, MESHES[shape])
    tspecs = _flat(tapi.param_specs(tconfigs.get(arch)))
    jspecs = _flat(japi.param_specs(jax_model(arch)))
    assert set(tspecs) == set(jspecs)
    for k, s in tspecs.items():
        assert (s.shape, s.axes) == (jspecs[k].shape, jspecs[k].axes), k
    for kw in _overlays(arch):
        rules = jsharding.ShardingConfig.make(**kw).rules
        for m in (None, mesh):
            got = _flat(tparam.param_pspecs(tapi.param_specs(
                tconfigs.get(arch)), rules, m))
            want = _flat(jax_param_pspecs(jax_model(arch), rules, m))
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, kw


def jax_param_pspecs(model, rules, mesh):
    from repro import param as jparam
    return jparam.param_pspecs(japi.param_specs(model), rules, mesh)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh((2, 4), ("data", "model"))
    P = tsharding.PartitionSpec
    assert tsharding.placements(P(("data",), None, "model"), mesh) == \
        (Shard(0), Shard(2))
    assert tsharding.placements(P(), mesh) == (Replicate(), Replicate())
    pod = FakeMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsharding.placements(P(("data", "pod")), pod) == \
        (Shard(0), Shard(0), Replicate())
    unit = FakeMesh((1, 1), ("data", "model"))
    assert tsharding.placements(P("data", "model"), unit) == \
        (Replicate(), Replicate())
    assert tsharding.local_shape((8, 12, 16), P("data", None, "model"),
                                 mesh) == (4, 12, 4)
    assert repr(P("data")) == "P('data',)" and P() == ()


def test_with_logical_constraint_is_identity_outside_a_mesh():
    x = torch.ones(4, 6)
    assert tsharding.with_logical_constraint(x, ("batch", "embed")) is x
    mesh = tmesh.make_test_mesh()
    with shardingx.use_mesh(mesh, tsharding.DEFAULT_RULES):
        # a plain tensor inside a mesh is left as it is (implicitly
        # replicated), as the JAX constraint leaves unsharded arrays
        assert tsharding.with_logical_constraint(x, ("batch", "embed")) is x


def test_with_logical_constraint_redistributes_a_dtensor():
    """Inside a mesh a DTensor takes the rules' placements, axes that do
    not divide dropped (6 heads stay whole over a 4-way model axis); the
    ambient rules are read when none are given."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = tmesh.make_test_mesh()
    dm = shardingx.device_mesh(mesh)
    x = DTensor.from_local(torch.empty((8, 16, 6), device="meta"), dm,
                           [Replicate(), Replicate()], run_check=False)
    with shardingx.use_mesh(mesh, tsharding.DEFAULT_RULES):
        y = tsharding.with_logical_constraint(x, ("batch", None, "heads"))
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert y.to_local().shape == (4, 16, 6)
        z = tsharding.with_logical_constraint(x, (None, "seq", "mlp"),
                                              {"seq": "model"})
        assert tuple(z.placements) == (Replicate(), Shard(1))
        assert z.to_local().shape == (8, 4, 6)
    assert shardingx.get_abstract_mesh() is None


def test_mesh_type_and_ambient_context():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.abstract
    assert tmesh.mesh_chips(mesh) == 512
    assert tmesh.make_test_mesh().shape == {"data": 2, "model": 4}
    assert tmesh.make_test_mesh(multi_pod=True).axis_sizes == (2, 2, 2)
    assert tmesh.make_unit_mesh().shape == {"data": 1, "model": 1}
    assert shardingx.get_abstract_mesh() is None
    outer, inner = tmesh.make_test_mesh(), tmesh.make_unit_mesh()
    with shardingx.use_mesh(outer, {"batch": "data"}):
        assert shardingx.get_abstract_mesh() is outer
        with shardingx.use_mesh(inner):
            assert shardingx.get_abstract_mesh() is inner
            assert shardingx.get_rules() is None
        assert shardingx.get_rules() == {"batch": "data"}
    assert shardingx.get_abstract_mesh() is None
    with pytest.raises(ValueError):
        shardingx.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    dm = shardingx.device_mesh(tmesh.make_test_mesh(multi_pod=True))
    assert dm.mesh_dim_names == ("pod", "data", "model")
    assert tuple(dm.shape) == (2, 2, 2)
    assert shardingx.device_mesh(tmesh.make_test_mesh(multi_pod=True)) is dm


def test_serve_and_worker_meshes_over_local_devices():
    """The JAX layout over explicit devices: one (n, 1) serve mesh; worker
    slices contiguous, leftovers unused, and device i % n reused when
    there are fewer devices than workers."""
    cpus = [torch.device("cpu")] * 8
    m = tmesh.make_serve_mesh(devices=cpus)
    assert m.shape == {"data": 8, "model": 1} and not m.abstract
    assert tmesh.make_serve_mesh(3, devices=cpus).shape["data"] == 3
    devs = [torch.device("cpu", i) for i in range(7)]
    sl = tmesh.make_worker_meshes(3, devs)
    assert [list(x.devices[:, 0]) for x in sl] == [devs[0:2], devs[2:4],
                                                   devs[4:6]]
    few = tmesh.make_worker_meshes(5, devs[:2])
    assert [list(x.devices[:, 0]) for x in few] == \
        [[devs[i % 2]] for i in range(5)]
    with pytest.raises(ValueError):
        tmesh.make_worker_meshes(0, devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_serve_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_worker_meshes(2)


class _JaxFakeMesh(FakeMesh):
    def __init__(self, devices, names):
        self.axis_names = tuple(names)
        self.devices = np.asarray(devices)


@pytest.mark.parametrize("shape,failed", [
    ((4, 2), [1]), ((4, 2), [0, 3]), ((2, 4, 2), [2]), ((4, 2), [7])])
def test_shrink_mesh_and_elastic_state_equal_jax(shape, failed,
                                                 monkeypatch):
    """The JAX functions run on a stand-in mesh (its re-mesh builds the
    same stand-in): the surviving rows, their devices and the elastic
    batch are equal; no surviving row raises in both."""
    from repro.compat import shardingx as jshardingx
    monkeypatch.setattr(jshardingx, "mesh_from_devices", _JaxFakeMesh)
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    arr = np.arange(int(np.prod(shape))).reshape(shape)
    jm = _JaxFakeMesh(arr, names)
    tm = shardingx.mesh_from_devices(arr, names)
    got, want = telastic.shrink_mesh(tm, failed), \
        jelastic.shrink_mesh(jm, failed)
    assert np.array_equal(got.devices.astype(int), want.devices)
    assert got.axis_names == want.axis_names
    ts = telastic.ElasticState(tm, 256).on_failure(failed)
    js = jelastic.ElasticState(jm, 256).on_failure(failed)
    assert (ts.global_batch, ts.generation) == (js.global_batch,
                                                js.generation)
    assert np.array_equal(ts.mesh.devices.astype(int), js.mesh.devices)
    rows = shape[names.index("data")]
    with pytest.raises(RuntimeError, match="all data-parallel rows"):
        telastic.shrink_mesh(tm, list(range(rows)))
    with pytest.raises(RuntimeError, match="all data-parallel rows"):
        jelastic.shrink_mesh(jm, list(range(rows)))


# ----------------------------------------- sharded steps on real numbers ----
#
# The dry run counts the sharded program on meta tensors, which hold no
# values.  Here the same layouts run on numbers: four CPU processes on the
# gloo backend, a (2, 2) (data, model) DeviceMesh, every argument laid out
# by its plan's spec, and the step's outputs gathered and held against the
# same step on plain tensors (float32, reduced configs).

def _gloo_cases():
    import dataclasses as dc
    from repro_torch.configs.reduced import reduce_arch, reduce_shape
    lm = reduce_arch(tconfigs.get("minitron-4b"))
    moe = reduce_arch(tconfigs.get("deepseek-moe-16b"))
    cases = {}
    for name, model, shape, kw in (
            ("lm_prefill", lm, "prefill_32k", dict()),
            ("lm_train", lm, "train_4k", dict(fsdp=True, act_seq=True)),
            ("lm_decode", lm, "decode_32k", dict(sequence_parallel=True)),
            ("lm_decode_dus", dc.replace(lm, cache_update="dus"),
             "decode_32k", dict(sequence_parallel=True)),
            ("lm_decode_masked", dc.replace(lm, cache_update="masked"),
             "decode_32k", dict(sequence_parallel=True)),
            ("lm_decode_int8", dc.replace(lm, quant_kv=True), "decode_32k",
             dict(sequence_parallel=True)),
            ("lm_decode_far", lm, "decode_32k", dict(sequence_parallel=True)),
            ("lm_decode_dus_far", dc.replace(lm, cache_update="dus"),
             "decode_32k", dict(sequence_parallel=True)),
            ("lm_decode_int8_far", dc.replace(lm, quant_kv=True),
             "decode_32k", dict(sequence_parallel=True)),
            ("moe_train", moe, "train_4k", dict(fsdp=True, act_seq=True)),
            ("vit_cls", reduce_arch(tconfigs.get("deit-b")), "cls_224",
             dict()),
            ("effnet_cls", reduce_arch(tconfigs.get("efficientnet-b7")),
             "cls_224", dict(extra={"batch": ("data", "model", "pod")})),
            ("det_train", dc.replace(reduce_arch(tconfigs.get(
                "tangram-detector")), canvas=64), "train_c32", dict()),
            ("dit_gen", reduce_arch(tconfigs.get("dit-s2")), "gen_fast",
             dict(extra={"seq": "data"}))):
        arch = model.name
        spec = next(s for s in tconfigs.arch_spec(arch).shapes
                    if s.name == shape)
        cases[name] = (model, reduce_shape(model, spec), kw)
    return cases


def _real_args(plan, seed):
    """The plan's arguments as numbers from a seed (equal on every
    process): uniform floats in [0, 0.1) (an optimizer's second moment
    must not be negative), ids in range, int8 over its range, ``valid`` a
    coin."""
    gen = torch.Generator().manual_seed(seed)

    def leaf(t):
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=gen) < 0.5
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 16, t.shape, generator=gen,
                                 dtype=t.dtype)
        if t.dtype == torch.int8:     # an int8 KV cache's values
            return torch.randint(-127, 128, t.shape, generator=gen,
                                 dtype=t.dtype)
        return torch.rand(t.shape, generator=gen, dtype=t.dtype) * 0.1
    return tuple(tparam.map_tree(leaf, a) for a in plan.args)


def _distribute(tree, specs, mesh, dm):
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh, dm) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, tsharding.PartitionSpec) and not isinstance(
            tree, torch.Tensor):
        return type(tree)(_distribute(v, s, mesh, dm)
                          for v, s in zip(tree, specs))
    return distribute_tensor(tree, dm, tsharding.placements(specs, mesh))


def _gathered(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, tuple):
        return [t for x in tree for t in _gathered(x)]
    return [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tparam.leaves(tree) if isinstance(t, torch.Tensor)]


def _gloo_worker(rank, world, port, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = shardingx.make_mesh((2, 2), ("data", "model"))
        dm = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                        mesh_dim_names=("data", "model"))
        cases = _gloo_cases()
        for name in names:
            model, shape, kw = cases[name]
            rules = tsharding.ShardingConfig.make(**kw).rules
            plan = tapi.plan_cell(model, shape, mesh, rules)
            args = _real_args(plan, 7)
            if name.endswith("_far"):
                # the decode step's device pos (random ids lie in [0, 16):
                # the first sequence shard) in the cache's last shard
                args = args[:-1] + (torch.tensor(shape.seq_len - 28,
                                                 dtype=torch.int32),)
            dargs = _distribute(args, plan.in_shardings, mesh, dm)
            # a copy for the plain step, whose decode writes its cache in
            # place (a replicated or chunked layout may share its memory)
            want = _gathered(plan.step_fn(*(
                tparam.map_tree(torch.clone, a) for a in args)))
            with shardingx.use_mesh(mesh, rules), implicit_replication():
                got = _gathered(plan.step_fn(*dargs))
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5,
                                           msg=lambda m: f"{name}: {m}")
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("names", [
    ("lm_prefill", "lm_train", "lm_decode"), ("moe_train",),
    ("vit_cls", "det_train"),
    ("effnet_cls", "dit_gen"),
    ("lm_decode_dus", "lm_decode_masked", "lm_decode_int8"),
    ("lm_decode_far", "lm_decode_dus_far", "lm_decode_int8_far")])
def test_sharded_steps_equal_plain_on_four_processes(names):
    """Reduced cells on a (2, 2) mesh of four gloo processes: the LM's
    prefill (heads, vocabulary and the embedding sharded over "model"),
    train step under FSDP and sequence-sharded activations (gradients,
    AdamW and the loss) and decode step over a sequence-sharded cache
    (written in place on the shard that holds the new row under
    ``"dus"``, blended shard by shard under ``"masked"`` and ``"auto"``,
    int8 values and scales too; the softmax reduced across the shards;
    ``pos`` a replicated 0-d int32, as the JAX plan's, in the first
    sequence shard and, ``*_far``, in the last),
    the MoE train step (expert-sharded einsums),
    DeiT's classification step (a vocabulary-sharded gather), the
    detector's train step (the target scatter on each device's canvases),
    EfficientNet's step over data x model (batch-norm statistics across
    the batch shards) and DiT's sampler with its tokens over "data": every
    output equals the plain step's."""
    import torch.multiprocessing as mp
    mp.start_processes(_gloo_worker, args=(4, _free_port(), names),
                       nprocs=4, join=True, start_method="spawn")
