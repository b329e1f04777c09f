"""The port's utils/profiling: a trace file with the annotated ranges, a
StepTimer that counts, and a debug mode that names a NaN's origin."""

import glob
import json

import pytest
import torch

from normalizingflow_tpu_torch.utils import (
    StepTimer,
    annotate,
    debug_mode,
    trace,
)

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    x = torch.randn(64, 32)
    with trace(str(tmp_path / "prof")):
        with annotate("nf_transition"):
            y = torch.tanh(x @ x.T)
        with annotate("nf_accept"):
            y.sum()
    files = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"nf_transition", "nf_accept"} <= names
    assert any("mm" in str(n) for n in names)


def test_step_timer_counts_steps_and_items():
    timer = StepTimer()
    for _ in range(3):
        timer.tick(8, result=(torch.ones(2), {"a": torch.zeros(1)}))
    timer.tick()
    rate = timer.rate()
    assert timer.steps == 4 and timer.items == 25
    assert rate["elapsed_s"] > 0
    assert rate["steps_per_s"] == pytest.approx(4 / rate["elapsed_s"])
    assert rate["items_per_s"] == pytest.approx(25 / rate["elapsed_s"])


def test_debug_mode_detects_a_nan_gradient():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="SqrtBackward0"):
        with debug_mode():
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()  # off again: no raise
