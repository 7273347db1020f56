"""The port's hillclimb driver (``repro_torch/launch/hillclimb.py``)
against the JAX package's (``repro/launch/hillclimb.py``): the same cells
and variants, each variant's model fields and rule table equal to the JAX
module's, the variants planned and counted on the test mesh, the
detector-stitch cell's input-bytes line, and the K4 tile search's file
and CPU refusal.

The JAX module sets ``XLA_FLAGS`` (512 host devices) at import, which
would change the device count of every later JAX test in this worker, so
it is read only in a subprocess (8 host devices, the test mesh).
"""
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.config import HardwareConfig
from repro_torch.core.partitioning import Patch
from repro_torch.core.stitching import build_batch_plan, stitch
from repro_torch.kernels.stitch import fused_embed
from repro_torch.kernels.stitch import ops as stitch_ops
from repro_torch.kernels.stitch.ref import stitch_reference
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb as hc
from repro_torch.launch.mesh import make_test_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]

_JAX_SIDE = r"""
import contextlib, dataclasses, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
from repro.launch import hillclimb as jh
from repro.launch.mesh import make_test_mesh
from repro.config import HardwareConfig
from repro.sharding import ShardingConfig
from repro import configs

def plain(x):
    if isinstance(x, dict):
        return {{str(k): plain(v) for k, v in x.items()}}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x

cells = {{}}
for cell, c in jh.CELLS.items():
    spec = configs.get(c["arch"])
    ov = spec.override(c["shape"])
    out = {{}}
    for name, kw in c["variants"].items():
        kw = dict(kw)
        fn = kw.pop("model_fn", None)
        model = fn(spec.model) if fn else spec.model
        if fn and ov.remat_policy and hasattr(model, "remat_policy"):
            # run_variant's override of a variant's model
            model = dataclasses.replace(model, remat_policy=ov.remat_policy)
        rules_kw = kw.pop("rules", None)
        base = dict(fsdp=ov.fsdp, sequence_parallel=ov.sequence_parallel,
                    act_seq=ov.act_seq, extra=ov.extra_rules)
        if rules_kw is not None:
            base.update(rules_kw)
        rules = ShardingConfig.make(**base).rules
        out[name] = {{"model": plain(dataclasses.asdict(model)),
                     "rules": plain(dict(rules)),
                     "kw": plain(kw), "has_rules": rules_kw is not None}}
    cells[cell] = {{"arch": c["arch"], "shape": c["shape"],
                    "variants": out}}

# detector_stitch with the detector cut to one layer (the input-bytes
# line reads the batch and the canvas only)
get = configs.get
def cut(arch_id):
    spec = get(arch_id)
    if arch_id == "tangram-detector":
        spec = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, n_layers=1))
    return spec
jh.cfg_registry.get = cut
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jh.run_detector_stitch(make_test_mesh(), HardwareConfig())
print(json.dumps({{"cells": cells, "detector": buf.getvalue()}}))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _plain(x):
    """JSON's view of a value (tuples are lists)."""
    return json.loads(json.dumps(x))


def test_cells_and_variants_equal_jax(jax_side):
    """Four cells, 23 variants, by name; each variant's model after its
    ``model_fn`` and the cell's remat override (as ``run_variant`` passes
    it) equal to the JAX one's on every field the port's config has (the
    port leaves out ``scan_layers`` and the TPU blocks), its rule table
    equal, and its other keywords (``accum_override`` with -1 for 1,
    ``grad_rs``) too."""
    jcells = jax_side["cells"]
    assert list(hc.CELLS) == list(jcells)
    assert sum(len(c["variants"]) for c in hc.CELLS.values()) == 23
    for cell, c in hc.CELLS.items():
        jc = jcells[cell]
        assert (c["arch"], c["shape"]) == (jc["arch"], jc["shape"])
        assert list(c["variants"]) == list(jc["variants"])
        spec = tconfigs.arch_spec(c["arch"])
        for name in c["variants"]:
            want = jc["variants"][name]
            kw = hc.variant_kwargs(cell, name)
            model = kw.pop("model_override") or spec.model
            got = _plain(dataclasses.asdict(model))
            assert set(got) <= set(want["model"]), (cell, name)
            left_out = set(want["model"]) - set(got)
            assert left_out <= {"scan_layers", "flash_block_q",
                                "flash_block_kv"}, (cell, name, left_out)
            assert got == {k: want["model"][k] for k in got}, (cell, name)
            rules = kw.pop("rules_override", None)
            assert (rules is not None) == want["has_rules"]
            if rules is None:
                rules = dryrun_rules(spec, c["shape"])
            assert _plain(dict(rules)) == want["rules"], (cell, name)
            jkw = dict(want["kw"])
            if jkw.get("accum_override") == -1:
                jkw["accum_override"] = 1
            assert kw == jkw, (cell, name)


def dryrun_rules(spec, shape_name):
    """The rule table ``dryrun.run_cell`` builds for a cell."""
    from repro_torch.sharding import ShardingConfig
    ov = spec.override(shape_name)
    return ShardingConfig.make(fsdp=ov.fsdp,
                               sequence_parallel=ov.sequence_parallel,
                               act_seq=ov.act_seq,
                               extra=ov.extra_rules).rules


@pytest.mark.parametrize("cell,variant", [
    ("llama4_train", "v7_accum1_group128"),
    ("mistral_decode", "v1_masked_update"),
    ("dit_gen", "v1_token_cp"),
    ("vit_serve", "v5_spatial_stem")])
def test_run_variant_on_the_test_mesh(cell, variant):
    """One variant of each cell planned and counted on the test mesh,
    every model cut to 2 layers: a row with the JAX row's keys and
    positive roofline terms."""
    dryrun._quiet()
    row = hc.run_variant(cell, variant, make_test_mesh(), HardwareConfig(),
                         depth=2, quick=True)
    assert {"cell", "variant", "t_compute", "t_memory", "t_collective",
            "bottleneck", "useful", "frac", "hbm_gib", "fits",
            "compile_s"} <= set(row)
    assert (row["cell"], row["variant"], row["depth"]) == (cell, variant, 2)
    for key in ("t_compute", "t_memory", "hbm_gib"):
        assert math.isfinite(row[key]) and row[key] > 0, key
    assert row["bottleneck"] in ("compute", "memory", "collective")


def test_masked_update_reads_the_whole_cache_in_the_count():
    """``mistral_decode`` on the test mesh at 2 layers: the masked write
    reads and writes each device's cache shard, the in-place one a row
    (at the step's device position every shard reads its clamped row,
    blends the new one in where it holds the position, and writes it
    back: 7 rows of k and of v a layer, ``attention._write_row``), so the
    counted bytes rise by the cache's read and write a layer, and no
    collective bytes move either way (each device blends or writes its
    own shard)."""
    from repro_torch import api
    dryrun._quiet()
    mesh = make_test_mesh()
    counts = {}
    for variant in ("base_dus", "v1_masked_update"):
        kw = hc.variant_kwargs("mistral_decode", variant, depth=2)
        model = kw["model_override"]
        spec = tconfigs.arch_spec("mistral-large-123b")
        shape = hc._shape("mistral-large-123b", "decode_32k")
        plan = api.plan_cell(dataclasses.replace(model, quant_weights=True),
                             shape, mesh, dryrun_rules(spec, shape.name))
        counts[variant] = dryrun.count_metrics(plan, mesh)
    dus, masked = counts["base_dus"], counts["v1_masked_update"]
    assert masked["coll"] == dus["coll"]
    assert masked["flops"] >= dus["flops"]
    cache = [t.to_local() for layer in api.abstract_args(plan, mesh)[2]
             .values() for t in layer.values()]
    cache_local = sum(t.numel() * t.element_size() for t in cache)
    rows = sum(t.numel() // t.shape[1] * t.element_size() for t in cache)
    # each layer's k and v: read and written in full by the blend, where
    # the in-place write moves its 7 rows
    assert masked["bytes"] - dus["bytes"] + 7 * rows >= 2 * cache_local
    assert 7 * rows < 1e-3 * cache_local


def test_stitch_window_equals_stitch_reference():
    """The meta-friendly stitch oracle of ``detector_stitch`` gives
    ``stitch_reference``'s canvases on the packer's plans."""
    for m, patch, seed in ((128, 32, 7), (256, 16, 3)):
        rng = np.random.default_rng(seed)
        patches = [Patch(0, 0, int(rng.integers(patch, m // 2 + 1)),
                         int(rng.integers(patch, m // 2 + 1)))
                   for _ in range(12)]
        plan = build_batch_plan(patches, stitch(patches, m, m), m, m)
        crops = [np.asarray(rng.normal(size=(p.h, p.w, 3)), np.float32)
                 for p in patches]
        slots = torch.from_numpy(stitch_ops.pack_plan_host(crops, plan))
        records = torch.from_numpy(plan.records)
        assert torch.equal(hc.stitch_window(slots, records, m, m),
                           stitch_reference(slots, records, m, m))


def test_detector_stitch_input_bytes_line_equals_jax(jax_side):
    """``run_detector_stitch`` on the test mesh (the detector cut to one
    layer): its rows, and the input-bytes line the JAX function prints."""
    dryrun._quiet()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = hc.run_detector_stitch(make_test_mesh(), HardwareConfig(),
                                      depth=1)
    lines = buf.getvalue().splitlines()
    want = jax_side["detector"].splitlines()
    assert lines[-1] == want[-1]
    assert lines[-1].startswith("  input bytes: canvases 96 MiB")
    assert [r["variant"] for r in rows] == [
        "base_host_assembled", "v1_device_stitch"]
    base, v1 = rows
    assert v1["arg_bytes"] < base["arg_bytes"]
    assert v1["flops"] == base["flops"]        # the same trunk
    assert v1["t_memory"] > 0 and base["t_memory"] > 0


def test_pick_tile_reads_the_fastest_row(tmp_path, monkeypatch):
    out = tmp_path / "hillclimb.json"
    monkeypatch.setattr(hc, "OUT", str(out))
    assert hc.pick_tile(1024, 1024, 32, 768, default="d") == "d"
    rows = [{"cell": "kernel_blocks", "variant": f"tile{t[0]}x{t[1]}",
             "m": 1024, "n": 1024, "patch": 32, "d_model": d,
             "tile": list(t), "ms_device": ms}
            for d, t, ms in ((768, (128, 192), 0.12), (768, (128, 128), 0.1),
                             (768, (128, 64), 0.2), (512, (128, 64), 0.05))]
    rows.append({"cell": "mistral_decode", "variant": "base_dus"})
    out.write_text(json.dumps(rows))
    assert hc.pick_tile(1024, 1024, 32, 768) == (128, 128)
    assert hc.pick_tile(1024, 1024, 32, 512) == (128, 64)
    assert hc.pick_tile(1024, 1024, 16, 384, default=None) is None
    assert hc.KERNEL_BLOCK_CANDIDATES == fused_embed.K4_TILES


def test_run_kernel_blocks_raises_on_the_cpu():
    with pytest.raises(ValueError, match="card"):
        hc.run_kernel_blocks(smoke=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hc.run_kernel_blocks(smoke=True)


def test_main_writes_build_hillclimb_json_only(tmp_path, monkeypatch):
    """``--cell mistral_decode --variant base_dus`` on the production mesh
    at 2 layers writes its row to ``build/hillclimb.json`` under the
    working directory (merged with the rows there), and the JAX package's
    ``out/hillclimb.json`` keeps its bytes."""
    tracked = ROOT / "out" / "hillclimb.json"
    before = hashlib.sha256(tracked.read_bytes()).hexdigest()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / "hillclimb.json").write_text(json.dumps(
        [{"cell": "mistral_decode", "variant": "base_dus", "stale": True},
         {"cell": "dit_gen", "variant": "base"}]))
    assert hc.main(["--cell", "mistral_decode", "--variant", "base_dus",
                    "--quick", "--depth", "2"]) == 0
    rows = json.loads((tmp_path / "build" / "hillclimb.json").read_text())
    assert [(r["cell"], r["variant"]) for r in rows] == [
        ("dit_gen", "base"), ("mistral_decode", "base_dus")]
    assert "stale" not in rows[1] and rows[1]["depth"] == 2
    assert not (tmp_path / "out").exists()
    assert hashlib.sha256(tracked.read_bytes()).hexdigest() == before
