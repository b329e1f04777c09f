"""The port's spans (utils.profiling.annotate) inside its hot loops: free
while no profiler runs, recorded under one, one range per unit of work as
the benchmark's per-layer readers count them, and the same bits either
way. CPU, float64."""

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from normalizingflow_tpu_torch import NormalizingFlow
from normalizingflow_tpu_torch.bijectors import AffineCoupling, Chain, SplineAR
from normalizingflow_tpu_torch.distributions import DiagNormal
from normalizingflow_tpu_torch.mcmc import padded_length, run_hmc
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.train.fused import train_flow_fused
from normalizingflow_tpu_torch.train.loop import bench_optimizer, train_step
from normalizingflow_tpu_torch.utils import annotate, profiling, trace

torch.set_num_threads(1)

DT = torch.float64
HMC_SPANS = ("hmc.grad",)
TRAIN_SPANS = ("train.loss", "train.backward")
SPLINE_SPANS = ("spline_ar.restack", "spline_ar.conditioner",
                "spline_ar.spline")


def profiled(fn):
    """fn()'s result and the profiler that recorded it (CPU activity)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def ranges(prof, names):
    """{name: sorted (start, end) of its ranges} for each of `names`."""
    found = {name: [] for name in names}
    for ev in prof.events():
        if ev.name in found:
            found[ev.name].append((ev.time_range.start, ev.time_range.end))
    return {name: sorted(r) for name, r in found.items()}


def assert_disjoint(spans):
    """Ranges of one name never nest or overlap: a reader that sums the
    kernels launched inside them counts each kernel once."""
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start


def gaussian_hmc(batched_target, num_warmup, num_samples, thin=1):
    def lp_batch(x):
        return -0.5 * torch.sum(x * x / torch.tensor([1.0, 4.0, 0.25],
                                                     dtype=DT), dim=-1)

    def lp_point(x):
        return lp_batch(x[None])[0]

    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn(8, 3, generator=gen, dtype=DT)
    res = run_hmc(gen, lp_batch if batched_target else lp_point, x0,
                  num_samples, num_warmup=num_warmup, step_size=0.3,
                  num_leapfrog=3, thin=thin, device="cpu",
                  batched_target=batched_target)
    return (res.samples, res.log_probs, res.accept_rate, res.step_size,
            res.inv_mass_diag)


def funnel_flow(seed):
    gen = torch.Generator().manual_seed(seed)
    return NormalizingFlow(DiagNormal(4, dtype=DT), Chain(
        [AffineCoupling(4, hidden_dim=8, generator=gen, dtype=DT)
         for _ in range(2)]))


def rkl_steps(steps=3):
    flow = funnel_flow(3)
    opt = bench_optimizer(list(flow.parameters()), steps, warmup_steps=1)
    gen = torch.Generator().manual_seed(5)
    losses = [train_step(flow, NealsFunnel(4), opt,
                         torch.randn(16, 4, generator=gen, dtype=DT))
              for _ in range(steps)]
    return losses + [p.detach() for p in flow.parameters()]


def fkl_steps(steps=3):
    flow = funnel_flow(4)
    gen = torch.Generator().manual_seed(6)
    batches = [torch.randn(16, 4, generator=gen, dtype=DT)
               for _ in range(steps)]
    hist = train_flow_fused(flow, gen, None, max_epochs=steps,
                            batch_size=16, learning_rate=1e-3,
                            batches=batches, device="cpu")
    return [torch.as_tensor(hist["losses"])] + [
        p.detach() for p in flow.parameters()]


def spline_inverse(dim=6, recorded=False):
    """The inverse on its buffered path, or with `recorded` on the stacked
    path autograd sees."""
    gen = torch.Generator().manual_seed(8)
    layer = SplineAR(dim, num_bins=4, tail_bound=3.0, hidden_dim=8,
                     generator=gen, dtype=DT)
    z = 2.0 * torch.rand(5, dim, generator=gen, dtype=DT) - 1.0
    if recorded:
        return tuple(v.detach() for v in layer.inverse(z))
    with torch.no_grad():
        return layer.inverse(z)


def test_annotate_is_a_shared_no_op_without_a_profiler(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return profiling._NO_SPAN

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    spans = [annotate("test.a"), annotate("test.b")]
    assert spans[0] is spans[1] is profiling._NO_SPAN
    with spans[0]:
        torch.ones(3).sum()
    assert entered == []


def test_annotate_records_its_range_under_a_profiler(tmp_path):
    def work():
        with annotate("test.outer"):
            with annotate("test.inner"):
                return torch.tanh(torch.ones(8, 8) @ torch.ones(8, 8))

    _, prof = profiled(work)
    found = ranges(prof, ("test.outer", "test.inner"))
    assert len(found["test.outer"]) == len(found["test.inner"]) == 1
    (o0, o1), (i0, i1) = found["test.outer"][0], found["test.inner"][0]
    assert o0 <= i0 <= i1 <= o1
    with trace(str(tmp_path)) as prof:
        work()
    assert len(ranges(prof, ("test.inner",))["test.inner"]) == 1


def test_the_flag_annotate_reads_follows_the_profiler():
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert annotate("test.on") is not profiling._NO_SPAN
    assert autograd_profiler._is_profiler_enabled is False
    assert annotate("test.off") is profiling._NO_SPAN


@pytest.mark.parametrize("batched_target", [True, False])
def test_run_hmc_records_leapfrog_steps_grad_spans_a_transition(
        batched_target):
    warmup, samples, thin, leapfrog = 129, 3, 2, 3
    _, prof = profiled(lambda: gaussian_hmc(batched_target, warmup,
                                            samples, thin))
    transitions = padded_length(warmup) + padded_length(samples) * thin
    assert transitions == 256 + 6  # the warmup's padded transitions too
    spans = ranges(prof, HMC_SPANS)["hmc.grad"]
    assert len(spans) == leapfrog * transitions
    assert_disjoint(spans)


def _assert_one_loss_then_backward_a_step(prof, steps):
    found = ranges(prof, TRAIN_SPANS)
    loss, back = found["train.loss"], found["train.backward"]
    assert len(loss) == len(back) == steps
    for (_, loss_end), (back_start, _) in zip(loss, back):
        assert loss_end <= back_start
    assert_disjoint(sorted(loss + back))


def test_train_step_records_one_loss_and_one_backward():
    _, prof = profiled(lambda: rkl_steps(3))
    _assert_one_loss_then_backward_a_step(prof, 3)


def test_train_flow_fused_records_one_loss_and_one_backward_a_step():
    _, prof = profiled(lambda: fkl_steps(4))
    _assert_one_loss_then_backward_a_step(prof, 4)


def _assert_three_parts_each_dim_step(recorded, monkeypatch):
    paths = {"buffered": 0, "stacked": 0}
    monkeypatch.setattr(SplineAR, "inverse_paths", paths)
    _, prof = profiled(lambda: spline_inverse(6, recorded))
    assert paths == {"buffered": int(not recorded), "stacked": int(recorded)}
    found = ranges(prof, SPLINE_SPANS)
    assert len(found["spline_ar.restack"]) == 5
    assert len(found["spline_ar.conditioner"]) == 5
    assert len(found["spline_ar.spline"]) == 6
    assert_disjoint(sorted(sum(found.values(), [])))


def test_spline_ar_inverse_records_its_three_parts_each_dim_step(
        monkeypatch):
    _assert_three_parts_each_dim_step(False, monkeypatch)


def test_spline_ar_stacked_inverse_records_its_three_parts_each_dim_step(
        monkeypatch):
    _assert_three_parts_each_dim_step(True, monkeypatch)


@pytest.mark.parametrize("path", [
    lambda: gaussian_hmc(True, 20, 4),
    lambda: gaussian_hmc(False, 20, 4),
    rkl_steps,
    fkl_steps,
    spline_inverse,
    lambda: spline_inverse(recorded=True),
], ids=["run_hmc", "run_hmc_per_point", "train_step", "train_flow_fused",
        "spline_ar_inverse", "spline_ar_inverse_stacked"])
def test_outputs_are_the_same_bits_with_and_without_a_profiler(path):
    plain = path()
    traced, _ = profiled(path)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
