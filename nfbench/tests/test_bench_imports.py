"""No nfbench module loads JAX or the JAX package (whole top-level names);
the references load nothing of the program."""

import json
import subprocess
import sys

import pytest

from nfbench import run

FORBIDDEN = ["jax", "jaxlib", "flax", "normalizingflow_tpu"]
MODULES = sorted(
    "nfbench." + str(p.relative_to(run.HERE).with_suffix("")).replace("/", ".")
    for p in run.HERE.rglob("*.py")
    if "tests" not in p.parts and "metrics" not in p.parts
    and "configs" not in p.parts and p.name != "__init__.py")
FILES = sorted(str(p) for sub in ("metrics", "configs")
               for p in (run.HERE / sub).glob("*.py"))


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", MODULES)
def test_module_loads_no_jax(module):
    assert not loaded_after(f"import {module}") & set(FORBIDDEN)


def test_metric_and_config_files_load_no_jax():
    code = "\n".join(
        f"run.load_file({f!r}, 'nfbench.x{i}')" for i, f in enumerate(FILES))
    assert not loaded_after("from nfbench import run\n" + code) & set(
        FORBIDDEN)


def test_a_whole_cpu_run_loads_no_jax():
    code = """
from nfbench import run
from nfbench.tests.toy import toy_cell
bench = run.load_bench()
run.run_cell(bench, toy_cell(bench, "funnel64_realnvp.rkl_train", 1))
"""
    assert not loaded_after(code) & set(FORBIDDEN)


def test_references_load_nothing_of_the_program():
    code = "\n".join(
        ["import importlib.util, sys",
         "sys.path.insert(0, '.')",
         "import nfbench.refcore"]
        + [f"s = importlib.util.spec_from_file_location('r{i}', {f!r})\n"
           f"m = importlib.util.module_from_spec(s)\n"
           f"s.loader.exec_module(m)"
           for i, f in enumerate(sorted(
               str(p) for p in (run.HERE / "configs").glob("*.py")))])
    loaded = loaded_after(code)
    assert "normalizingflow_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
