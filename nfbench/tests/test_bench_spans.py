"""The readers of the per-layer metrics that read the program's own spans,
on hand-built trace summaries: device ms a unit of the kernels launched
inside the span, and nothing where the trace holds no such span (a
program without it)."""

from types import SimpleNamespace

import pytest

from nfbench import run
from nfbench.trace import Summary

SPANS = {
    "grad_device_ms.neutra": "hmc.grad",
    "forward_device_ms.train": "train.loss",
    "backward_device_ms.train": "train.backward",
    "conditioner_device_ms.nf_sample": "spline_ar.conditioner",
    "restack_device_ms.nf_sample": "spline_ar.restack",
    "spline_device_ms.nf_sample": "spline_ar.spline",
}


def reader(metric):
    return run.load_file(run.HERE / "metrics" / f"{metric}.py",
                         f"nfbench.metrics.{metric}")


def summary(span, units=2):
    """Two `span` ranges inside the benchmark's own, each launching one
    kernel (500 and 300 ns), and kernels launched outside them: in
    between, in another of the program's spans, and a copy."""
    other = next(s for s in SPANS.values() if s != span)
    return Summary(
        window_s=1.0, busy_s=1e-6, units=units,
        kernels=[("k_in_0", 1000, 1500, 150),
                 ("k_between", 1500, 3500, 250),
                 ("k_in_1", 3500, 3800, 390),
                 ("k_other", 4000, 9000, 450),
                 (None, 9000, 9100, 160)],
        ranges=[("run_hmc", 0, 1000), (span, 100, 200), (span, 300, 400),
                (other, 420, 480)])


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reads_device_ms_a_unit_launched_in_its_span(metric):
    # k_in_0 and k_in_1 are the span's, 800 ns over 2 units; kernels only,
    # as Summary.seconds_launched_in counts them (the copy is left out)
    ctx = SimpleNamespace(trace=summary(SPANS[metric]))
    assert reader(metric).read(ctx) == pytest.approx(1e3 * 800e-9 / 2)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reads_nothing_without_its_span(metric):
    t = summary(SPANS[metric])
    t.ranges = [r for r in t.ranges if r[0] != SPANS[metric]]
    assert reader(metric).read(SimpleNamespace(trace=t)) is None
    assert reader(metric).read(SimpleNamespace(trace=None)) is None


def test_every_span_reader_is_in_the_benchmark(bench):
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for metric, span in SPANS.items():
        assert per_layer[metric]["layer"] == span
        assert per_layer[metric]["source"] == "device_trace"
