"""A configuration, a traffic mix and a metric added as new files, with
their entries in BENCHMARK.json, run without an edit to a file that
exists."""
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

from tb_fixtures import tiny_config, tiny_traffic

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def digests(folder: pathlib.Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def make_checkout(tmp_path) -> pathlib.Path:
    """A copy of the benchmark beside a link to the program."""
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    shutil.copytree(BENCH, checkout / "tangram_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (checkout / "src").symlink_to(ROOT / "src")
    return checkout


def add_cell(checkout, bench, cfg, traffic_name="tiny_mix"):
    """``cfg``'s file, the tiny traffic and the cell ``<name>-mix``, as
    new files and entries."""
    name = cfg["name"]
    (checkout / f"tangram_bench/configs/{name}.json").write_text(
        json.dumps(cfg))
    # a backlog that the 3 s window cannot serve dry on a fast host
    (checkout / f"tangram_bench/traffic/{traffic_name}.json").write_text(
        json.dumps(tiny_traffic(name=traffic_name,
                                backlog_frames_per_camera=4000)))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"tangram_bench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": f"{name}-mix", "config": name,
                               "traffic": traffic_name, "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "patches_per_s":
            m["workloads"].append(f"{name}-mix")


def run_cell(checkout, cell, extra="") -> dict:
    """A tiny run of ``cell`` in a fresh process from ``checkout``: the
    cell's end-to-end metrics' names and values, and whether it was
    correct; ``extra`` adds keys to what is printed."""
    code = f"""
import sys, json, torch
sys.path[:0] = [{str(checkout)!r}, {str(checkout / 'src')!r}]
from tangram_bench import families, harness
assert harness.ROOT == __import__('pathlib').Path({str(checkout)!r})
cell, cfg, traffic, bench = harness.load_cell({cell!r})
names = [m["name"] for m in harness.cell_metrics(bench, cell["name"], False)]
checks, data, _, _ = harness.run_checked(cfg, traffic, 5,
                                         torch.device("cpu"), 3.0)
values = {{n: harness.load_reader(n)(data) for n in names
          if n != "setup_s"}}
lim = harness.limits_of(cfg)
print(json.dumps({{"names": names, "values": values,
                  "correct": all(checks[k] <= lim[k] for k in lim),
                  {extra}}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=checkout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found_by_name(tmp_path):
    checkout = make_checkout(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(checkout / "tangram_bench")

    # the additions: files and entries only
    add_cell(checkout, bench,
             dict(tiny_config(name="tiny_det"), source="a CPU-sized test"))
    (checkout / "tangram_bench/metrics/routed_canvases.py").write_text(
        '"""routed_canvases: canvases routed in the window."""\n\n\n'
        "def read(run):\n"
        "    return float(sum(r.n_canvases for r in run.invs\n"
        "                     if r.t_routed is not None\n"
        "                     and r.t_routed <= run.seconds))\n")
    bench["end_to_end"].append({"name": "routed_canvases", "unit": "canvases",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny_det-mix"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    got = run_cell(checkout, "tiny_det-mix")
    assert set(got["names"]) == {"patches_per_s", "routed_canvases",
                                 "setup_s"}
    assert got["values"]["routed_canvases"] > 0
    assert got["values"]["patches_per_s"] > 0
    assert got["correct"]
    after = digests(checkout / "tangram_bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_family_added_as_a_new_file_is_found_by_name(tmp_path):
    """A family file (here one that re-exports ``vit``) and a
    configuration that names it: the run looks the family up by that
    name and is correct, and no file that was there changed."""
    checkout = make_checkout(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(checkout / "tangram_bench")

    (checkout / "tangram_bench/families/tiny_alias.py").write_text(
        '"""The plain ViT under another name."""\n'
        "from tangram_bench.families.vit import (  # noqa: F401\n"
        "    KEYS, detector_raw, flops_per_canvas, leaf_specs)\n")
    add_cell(checkout, bench, dict(tiny_config(name="tiny_fam"),
                                   family="tiny_alias"))
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    got = run_cell(checkout, "tiny_fam-mix",
                   '"family": families.load(cfg).__name__')
    assert got["family"] == "tangram_bench.families.tiny_alias"
    assert got["values"]["patches_per_s"] > 0
    assert got["correct"]
    after = digests(checkout / "tangram_bench")
    assert {k: v for k, v in after.items() if k in before} == before
