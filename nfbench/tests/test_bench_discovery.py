"""The harness finds every cell's files by name, and a cell added as files
alone is picked up."""

import json
import shutil
import subprocess
import sys

from nfbench import run
from nfbench.tests.toy import TOY


def test_every_name_resolves(bench):
    names = {w["name"] for w in bench["workloads"]}
    assert names == set(TOY)
    for w in bench["workloads"]:
        cell = run.Cell(bench, w["name"], 1, 1.0, 0, "cpu")
        kind = run.importlib.import_module(
            f"nfbench.kinds.{cell.traffic['kind']}")
        assert callable(kind.run)
        assert cell.cfg["name"] == w["config"]
        assert cell.limits, f"no limits for {w['name']}"
    for c in bench["configs"]:
        assert (run.ROOT / c["file"]).exists()
        assert (run.HERE / "configs" / f"{c['name']}.py").exists()
    for m in bench["per_layer"]:
        reader = run.load_file(run.HERE / "metrics" / f"{m['name']}.py",
                               f"nfbench.metrics.{m['name']}")
        assert callable(reader.read)
        assert run.cells_reporting(bench, m) <= names


def test_cell_added_as_files_alone(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    BENCHMARK.json entry runs the new cell, no code edited."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "nfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((run.HERE / "traffic" / "nf_sample.json")
                         .read_text())
    traffic["batch"] = 48
    (root / "nfbench" / "traffic" / "nf_sample_small.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({
        "name": "lj32_nsf_ar.nf_sample_small", "config": "lj32_nsf_ar",
        "traffic": "nf_sample_small", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lj32_nsf_ar.nf_sample" in m.get("workloads", []):
            m["workloads"].append("lj32_nsf_ar.nf_sample_small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys
sys.path.insert(0, {str(root)!r})
sys.path.append({str(run.ROOT)!r})  # the program, beside the copy
from nfbench import run
bench = run.load_bench()
cell = run.Cell(bench, "lj32_nsf_ar.nf_sample_small", 3, 0.2, 0, "cpu",
                overrides={{"cfg": {{"nparticles": 4, "hidden_dim": 8,
                                     "nsplines": 4}},
                           "traffic": {{"check_rows": 8, "bound_rows": 8}}}})
assert cell.traffic["batch"] == 48
line = run.run_cell(bench, cell)
assert run.HERE == __import__("pathlib").Path({str(root / 'nfbench')!r})
print(json.dumps(line))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["attempted"] >= 1
    assert "nf_frames_per_s" in line["metrics"]
