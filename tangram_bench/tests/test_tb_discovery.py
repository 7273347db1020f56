"""A configuration, a traffic mix and a metric added as new files, with
their entries in BENCHMARK.json, run without an edit to a file that
exists."""
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

from conftest import tiny_config, tiny_traffic

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def digests(folder: pathlib.Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    shutil.copytree(BENCH, checkout / "tangram_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (checkout / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(checkout / "tangram_bench")

    # the additions: files and entries only
    cfg = dict(tiny_config(name="tiny_det"), source="a CPU-sized test")
    (checkout / "tangram_bench/configs/tiny_det.json").write_text(
        json.dumps(cfg))
    (checkout / "tangram_bench/traffic/tiny_mix.json").write_text(
        json.dumps(tiny_traffic(name="tiny_mix")))
    (checkout / "tangram_bench/metrics/routed_canvases.py").write_text(
        '"""routed_canvases: canvases routed in the window."""\n\n\n'
        "def read(run):\n"
        "    return float(sum(r.n_canvases for r in run.invs\n"
        "                     if r.t_routed is not None\n"
        "                     and r.t_routed <= run.seconds))\n")
    bench["configs"].append({"name": "tiny_det", "source": "a test",
                             "file": "tangram_bench/configs/tiny_det.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_det-mix", "config": "tiny_det",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "routed_canvases", "unit": "canvases",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny_det-mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "patches_per_s":
            m["workloads"].append("tiny_det-mix")
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    code = f"""
import sys, json, torch
sys.path[:0] = [{str(checkout)!r}, {str(checkout / 'src')!r}]
from tangram_bench import harness
assert harness.ROOT == __import__('pathlib').Path({str(checkout)!r})
cell, cfg, traffic, bench = harness.load_cell("tiny_det-mix")
names = [m["name"] for m in harness.cell_metrics(bench, cell["name"], False)]
checks, data, _, _ = harness.run_checked(cfg, traffic, 5,
                                         torch.device("cpu"), 3.0)
values = {{n: harness.load_reader(n)(data) for n in names
          if n != "setup_s"}}
lim = harness.limits_of(cfg)
print(json.dumps({{"names": names, "values": values,
                  "correct": all(checks[k] <= lim[k] for k in lim)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=checkout)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got["names"]) == {"patches_per_s", "routed_canvases",
                                 "setup_s"}
    assert got["values"]["routed_canvases"] > 0
    assert got["values"]["patches_per_s"] > 0
    assert got["correct"]
    after = digests(checkout / "tangram_bench")
    assert {k: v for k, v in after.items() if k in before} == before
