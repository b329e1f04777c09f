"""On the card: one run of each cell, short, by its command; its
line must be correct. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from nfbench import run


@pytest.mark.card
@pytest.mark.parametrize("workload", [
    "funnel64_realnvp.neutra_hmc", "lj32_nsf_ar.fkl_train",
    "lj32_nsf_ar.nf_sample", "funnel64_realnvp.rkl_train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "nfbench.run", "--workload", workload,
         "--seed", "2147483911", "--seconds", "5", "--trace", str(trace)],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
