"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke`` and the port's examples pulls in neither JAX nor the JAX
package, needs no CUDA compiler, builds no kernel, starts no process
group and sets no environment variable; entry points default to CUDA and
never fall back to the CPU."""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import _build
from test_torch_cuda import load_example

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, importlib.util, json, pathlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
# the simulation substrate and the paper's metrics, named so that a
# module missing from the walk still fails here
names += ["repro_torch.serverless.platform", "repro_torch.core.scheduler",
          "repro_torch.core.baselines", "repro_torch.core.adaptive",
          "repro_torch.core.cost", "repro_torch.models.quantize",
          "repro_torch.core.workers", "repro_torch.models.efficientnet",
          "repro_torch.compat.shardingx", "repro_torch.sharding",
          "repro_torch.api", "repro_torch.launch.mesh",
          "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
          "repro_torch.launch.hillclimb",
          "repro_torch.configs.mistral_large_123b"]
import os
env = dict(os.environ)
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch.distributed as dist
from repro_torch.kernels import _build
for path in sorted(pathlib.Path({root!r}, "examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({{"modules": len(names), "bad": bad,
                   "builds": len(_build.BUILDS),
                   "process_group": dist.is_initialized(),
                   "env_changed": sorted(k for k in set(env) | set(os.environ)
                                         if env.get(k) != os.environ.get(k))}}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 25
    assert out["bad"] == []
    assert out["builds"] == 0          # nothing compiled at import
    # the mesh, sharding and dry-run modules start no process group (the
    # dry run's fake group starts on first use) and set no environment
    # variable (the JAX dry run sets XLA_FLAGS at import)
    assert out["process_group"] is False
    assert out["env_changed"] == []


_SERVE_PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke
from repro_torch.launch import serve, train
from repro_torch.models import (attention, detector, dit, efficientnet,
                                moe, transformer, vit)
from repro_torch.training import elastic, optimizer, train_state
print(json.dumps([m for m in ("torch.distributed.tensor", "sympy")
                  if m in sys.modules]))
"""


def test_serving_and_training_import_no_dtensor():
    """The serve and train paths, the models and ``chip_smoke`` import
    neither DTensor nor what it pulls in (sympy and some 500 more modules,
    which every full garbage collection of a host-bound serving, decode or
    training loop would walk); only the dry run imports it."""
    code = _SERVE_PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_STEP_PROBE = """
import json, sys
sys.path[:0] = [{src!r}]
import torch
from repro_torch import configs
from repro_torch.configs.reduced import reduce_arch
from repro_torch.models import dit, efficientnet, transformer, vit
g = torch.Generator().manual_seed(0)
cfg = reduce_arch(configs.get({arch!r}))
if {arch!r} in ("minitron-4b", "deepseek-moe-16b"):
    import dataclasses
    cfg = dataclasses.replace(cfg, cache_update="dus")
    params = transformer.init_params(cfg, g, "cpu")
    cache = transformer.init_cache(cfg, 2, 8, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 1), generator=g)
    logits = transformer.decode_step(cfg, params, tokens, cache, 0)[0]
elif {arch!r} == "efficientnet-b7":
    params = efficientnet.init_params(cfg, g, "cpu")
    logits = efficientnet.forward(cfg, params, torch.rand(2, 64, 64, 3))
elif {arch!r} == "vit-b16":
    params = vit.init_params(cfg, g, "cpu")
    logits = vit.forward(cfg, params, torch.rand(2, 64, 64, 3),
                         impl="flash")[0]
else:
    params = dit.init_params(cfg, g, "cpu")
    side = cfg.img_res // cfg.vae_factor
    logits = dit.forward(cfg, params,
                         torch.randn(2, side, side, cfg.latent_channels),
                         torch.tensor([3, 500]), torch.tensor([1, 2]),
                         impl="flash")
assert torch.isfinite(logits.float()).all()
print(json.dumps([m for m in ("torch.distributed.tensor", "sympy")
                  if m in sys.modules]))
"""


@pytest.mark.parametrize("arch", ["minitron-4b", "deepseek-moe-16b",
                                  "efficientnet-b7", "vit-b16", "dit-xl2"])
def test_one_step_off_a_mesh_loads_no_dtensor(arch):
    """One CPU decode step of a reduced LM (in-place cache write) and one
    forward of a reduced vision or diffusion model load neither DTensor
    nor sympy: a placement is imported only on a DTensor's branch.
    Importing the modules (above) runs none of that code."""
    code = _STEP_PROBE.format(src=str(ROOT / "src"), arch=arch)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"] + EXAMPLES))
def test_source_names_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", text,
                         re.M), path
    assert not re.search(r"^\s*from\s+repro\.", text, re.M), path


def test_port_has_the_four_examples():
    assert [p.name for p in EXAMPLES] == [
        "torch_lm_sequence_packing.py", "torch_quickstart.py",
        "torch_serve_e2e.py", "torch_train_detector.py"]


@pytest.mark.parametrize("path", [p.name for p in EXAMPLES])
def test_examples_default_to_cuda_and_raise_without_it(path, monkeypatch):
    """With no argument an example asks for CUDA; on a host without it
    (here: ``torch.cuda.is_available`` reports none) it raises before any
    work and never falls back to the CPU."""
    mod = load_example(path[:-3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device_lib.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            device_lib.resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            device_lib.resolve_device("cuda:0")


def test_kernel_build_needs_nvcc():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert _build.nvcc_path()
    else:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()
