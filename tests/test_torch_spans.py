"""The port's spans (utils.profiling.annotate) inside its hot loops: free
while no profiler runs, recorded under one, one range per unit of work as
the benchmark's per-layer readers count them, and the same bits either
way. CPU, float64."""

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from normalizingflow_tpu_torch import NormalizingFlow
from normalizingflow_tpu_torch.bijectors import (
    AffineCoupling,
    Chain,
    SplineAR,
    TransformerCoupling,
)
from normalizingflow_tpu_torch.distributions import DiagNormal
from normalizingflow_tpu_torch.mcmc import padded_length, run_hmc
from normalizingflow_tpu_torch.targets import LennardJones, NealsFunnel
from normalizingflow_tpu_torch.train.fused import train_flow_fused
from normalizingflow_tpu_torch.train.loop import bench_optimizer, train_step
from normalizingflow_tpu_torch.utils import annotate, profiling, trace

torch.set_num_threads(1)

DT = torch.float64
HMC_SPANS = ("hmc.grad",)
TRAIN_SPANS = ("train.loss", "train.backward")
SPLINE_SPANS = ("spline_ar.restack", "spline_ar.conditioner",
                "spline_ar.spline")
TCL_SPANS = ("tcl.attention", "tcl.sdpa", "tcl.mlp", "tcl.spline")
LJ_BOX = 3.0


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


def tcl_flow(layers=3, blocks=2):
    gen = torch.Generator().manual_seed(9)
    return NormalizingFlow(DiagNormal(24, dtype=DT), Chain(
        [TransformerCoupling(8, LJ_BOX, i % 3, num_bins=4, embed_dim=8,
                             num_heads=2, num_blocks=blocks, num_freqs=2,
                             generator=gen, dtype=DT)
         for i in range(layers)]))


def lj_target():
    return LennardJones(8, LJ_BOX, cutoff=1.4, kT=2.0, dtype=DT)


def tcl_rkl_steps(steps=2, layers=3):
    """Reverse-KL steps of an NSF_TCL flow against an LJ target."""
    flow = tcl_flow(layers)
    opt = bench_optimizer(list(flow.parameters()), steps, warmup_steps=1)
    gen = torch.Generator().manual_seed(10)
    losses = [train_step(flow, lj_target(), opt,
                         (torch.rand(4, 24, generator=gen, dtype=DT) - 0.5)
                         * LJ_BOX) for _ in range(steps)]
    return losses + [p.detach() for p in flow.parameters()]


def lj_hmc(num_samples=3, thin=2):
    """HMC on an LJ target from a jittered lattice, as sample_data runs
    it."""
    gen = torch.Generator().manual_seed(12)
    grid = torch.stack(torch.meshgrid(*[torch.arange(2, dtype=DT)] * 3,
                                      indexing="ij"), -1).reshape(8, 3)
    x0 = (grid * LJ_BOX / 2 - LJ_BOX / 4).reshape(1, 24) + 0.02 * torch.randn(
        5, 24, generator=gen, dtype=DT)
    res = run_hmc(gen, lj_target().log_prob, x0, num_samples, num_warmup=0,
                  step_size=0.005, num_leapfrog=3, thin=thin, device="cpu")
    return res.samples, res.log_probs


@pytest.mark.parametrize("layers,blocks", [(3, 2), (2, 1)])
def test_tcl_forward_pass_records_its_spans_a_layer_and_block(layers,
                                                              blocks):
    flow = tcl_flow(layers, blocks)
    z = (torch.rand(4, 24, dtype=DT,
                    generator=torch.Generator().manual_seed(11)) - 0.5) * 3
    _, prof = profiled(lambda: flow.inverse(z))
    found = ranges(prof, TCL_SPANS)
    # attention (and its SDPA call) once a block; the MLP ranges: the wrap
    # and embedding, then each block's MLP, the last with the output
    # projection; the spline once a layer
    assert len(found["tcl.attention"]) == layers * blocks
    assert len(found["tcl.sdpa"]) == layers * blocks
    assert len(found["tcl.mlp"]) == layers * (blocks + 1)
    assert len(found["tcl.spline"]) == layers
    assert_disjoint(sorted(found["tcl.attention"] + found["tcl.mlp"]
                           + found["tcl.spline"]))
    for name in TCL_SPANS:
        assert_disjoint(found[name])
    for s0, s1 in found["tcl.sdpa"]:
        assert any(a0 <= s0 <= s1 <= a1 for a0, a1 in found["tcl.attention"])


def test_lj_energy_records_one_range_a_rkl_step():
    _, prof = profiled(lambda: tcl_rkl_steps(3, layers=2))
    spans = ranges(prof, ("lj.energy",))["lj.energy"]
    assert len(spans) == 3
    assert_disjoint(spans)


def test_lj_energy_records_one_range_a_gradient_evaluation():
    samples, thin, leapfrog = 3, 2, 3
    _, prof = profiled(lambda: lj_hmc(samples, thin))
    spans = ranges(prof, ("lj.energy",))["lj.energy"]
    # L a transition, and one for the initial state of the run
    assert len(spans) == leapfrog * samples * thin + 1
    assert_disjoint(spans)


def test_tcl_and_lj_spans_are_no_ops_without_a_profiler(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return profiling._NO_SPAN

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tcl_rkl_steps(2, layers=1)
    lj_hmc(1, 1)
    assert entered == []


@pytest.mark.parametrize("path", [
    lambda: gaussian_hmc(True, 20, 4),
    lambda: gaussian_hmc(False, 20, 4),
    rkl_steps,
    fkl_steps,
    spline_inverse,
    lambda: spline_inverse(recorded=True),
    tcl_rkl_steps,
    lj_hmc,
], ids=["run_hmc", "run_hmc_per_point", "train_step", "train_flow_fused",
        "spline_ar_inverse", "spline_ar_inverse_stacked", "tcl_train_step",
        "lj_run_hmc"])
def test_outputs_are_the_same_bits_with_and_without_a_profiler(path):
    plain = path()
    traced, _ = profiled(path)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
