"""The port's weak-scaling bench (normalizingflow_tpu_torch/bench_scaling.py)
on the CPU: world size 1 in the process and two gloo ranks spawned, with
tiny chain counts. On the CPU the efficiency means nothing (the ranks
share one host's cores); these tests check the method and the lines."""

import json

import pytest
import torch

from normalizingflow_tpu_torch import bench, bench_scaling
from normalizingflow_tpu_torch.mcmc import hmc as thmc
from normalizingflow_tpu_torch.mcmc import padded_length
from normalizingflow_tpu_torch.parallel import make_mesh
from normalizingflow_tpu_torch.targets import NealsFunnel

torch.set_num_threads(1)

TINY = dict(train_steps=3, lr_warmup=1, chains_per_device=8, draws=4)


def lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()]


def test_weak_scaling_over_two_gloo_ranks(capsys):
    assert bench_scaling.main(device="cpu", **TINY) == 0
    w1, w2, summary = lines(capsys)
    for line, world in ((w1, 1), (w2, 2)):
        assert line["metric"] == "neutra_hmc_draws_per_s"
        assert line["mesh_devices"] == world and line["backend"] == "gloo"
        assert line["chains"] == TINY["chains_per_device"] * world
        assert line["unit"] == "draws/s" and line["value"] > 0
        # value = chains * draws / seconds, sample_s rounded to 1 ms
        assert abs(line["value"] * line["sample_s"]
                   - line["chains"] * TINY["draws"]) <= (
            line["value"] * 5e-4 + 0.05 * line["sample_s"] + 1e-9)
    assert summary["metric"] == "scaling_efficiency"
    assert summary["devices"] == 2
    assert summary["value"] == round(w2["value"] / (2 * w1["value"]), 4)
    # vs_baseline is rounded from the unrounded efficiency
    assert summary["vs_baseline"] == pytest.approx(summary["value"] / 0.9,
                                                   abs=1e-4)
    assert "CPU" in summary["note"]


def test_one_device_prints_null(capsys, monkeypatch):
    monkeypatch.setattr(bench_scaling, "CPU_WORLD", 1)
    assert bench_scaling.main(device="cpu", **TINY) == 0
    w1, summary = lines(capsys)
    assert w1["mesh_devices"] == 1
    assert summary["metric"] == "scaling_efficiency"
    assert summary["value"] is None and "single device" in summary["note"]


def test_throughput_runs_the_timed_phase_alone(monkeypatch):
    """On a one-rank mesh: adaptation (padded warmup 50 + 2 draws), one warm
    run and one timed run of `draws` transitions each."""
    count = [0]
    real = thmc.accept_select_fused

    def tail(*a, **k):
        count[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(thmc, "accept_select_fused", tail)
    mesh = make_mesh(device="cpu")
    flow = bench.build_flow(hidden=16, dim=8, device="cpu")
    draws = 6
    thr, dt = bench_scaling.throughput(
        mesh, flow, NealsFunnel(8), torch.Generator().manual_seed(0),
        chains_per_device=8, draws=draws)
    assert count[0] == (padded_length(bench_scaling.WARMUP) + 2
                        + 2 * padded_length(draws))
    assert thr == pytest.approx(8 * draws / dt)
    assert all(p.requires_grad for p in flow.parameters())
