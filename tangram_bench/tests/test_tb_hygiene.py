"""Nothing the benchmark runs loads JAX or the JAX package; the reference
and the yardstick import nothing of the port either."""
import ast
import json
import pathlib
import subprocess
import sys
import types

import pytest

from tangram_bench import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: the yardstick: what a change to the program must not be able to move
YARDSTICK = ["reference.py", "counters.py", "weights.py", "stats.py",
             "trace.py", "traffic/generator.py",
             *[f"metrics/{p.name}" for p in (BENCH / "metrics").glob("*.py")]]


def top_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    bad = top_imports(BENCH / rel) & {"jax", "jaxlib", "flax", "repro",
                                      "repro_torch"}
    assert not bad, (rel, bad)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_imports(path) & {"jax", "jaxlib", "flax", "repro"}, \
            path


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod",
                        types.ModuleType("repro_torch_fake_mod"))
    monkeypatch.setitem(sys.modules, "jaxlib_fake.sub",
                        types.ModuleType("jaxlib_fake.sub"))
    assert "repro_torch_fake_mod" not in harness.forbidden_loaded()
    assert "jaxlib_fake" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.fake_sub",
                        types.ModuleType("repro.fake_sub"))
    assert "repro" in harness.forbidden_loaded()


def test_a_run_loads_no_jax_and_no_repro():
    """A whole tiny run in a fresh process, then ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                {str(BENCH / 'tests')!r}]
import torch
from tb_fixtures import tiny_config, tiny_traffic
from tangram_bench import harness
checks, *_ = harness.run_checked(tiny_config(), tiny_traffic(), 3,
                                 torch.device("cpu"), 0.5)
import json
print(json.dumps(harness.forbidden_loaded()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_refuses_without_a_card(tmp_path):
    """No CUDA device: a code other than 0 and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "tangram-replay", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
