"""Each cell's dry run on the CPU at toy sizes gives a last line of the
required shape; without a card the command prints no result."""

import json
import math
import subprocess
import sys

import pytest

from nfbench import run
from nfbench.tests.toy import TOY, toy_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", sorted(TOY))
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_line(bench, workload, trace):
    line = run.run_cell(bench, toy_cell(bench, workload, 2**31 + 12345,
                                        trace=trace))
    json.loads(json.dumps(line))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run measures no device: no per-layer metric is reported
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == e2e
        for m in line["metrics"].values():
            assert math.isfinite(m["value"]) and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on
    stdout."""
    out = subprocess.run(
        [sys.executable, "-m", "nfbench.run", "--workload",
         "lj32_nsf_ar.nf_sample", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
