"""The port's bench (normalizingflow_tpu_torch/bench.py, utils/mfu.py)
against bench.py's definitions and the JAX package, on the CPU in float64.

bench.py itself is not imported (its import turns on a persistent compile
cache); the JAX side is built here from the JAX package as bench.py builds
it. torch cannot draw JAX's threefry stream, so the timed phase is fed
JAX's own per-transition draws (test_torch_hmc.jax_run_draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.estimators.ess import (
    bulk_ess_per_dim as j_bulk_ess_per_dim,
    ess_per_dim as j_ess_per_dim,
    tail_ess as j_tail_ess,
)
from normalizingflow_tpu.mcmc.hmc import run_hmc as j_run_hmc
from normalizingflow_tpu.mcmc.neutra import (
    pullback_logprob_batched as j_pullback,
)
from normalizingflow_tpu.targets import (
    IllConditionedGaussian as JIllCond,
    NealsFunnel as JFunnel,
)

from normalizingflow_tpu_torch import bench
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.mcmc import hmc as thmc
from normalizingflow_tpu_torch.mcmc import padded_length
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.utils import mfu

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")

# bench.py:199-215, without "params" (the port trains the flow in place)
HMC_KEYS = {"ess_per_s", "ess_min_bulk_x", "ess_min_bulk_x2",
            "ess_median_bulk_x", "ess_min_raw_x", "ess_min_raw_x2",
            "ess_tail_hardest_coord", "ess_cap", "sample_s", "sample_s_all",
            "train_s", "final_reverse_kl", "accept", "samples"}
# bench.py:269-282
NUTS_KEYS = {"ess_per_s", "ess_min_bulk_x", "ess_min_bulk_x2", "ess_cap",
             "sample_s", "sample_s_all", "mean_tree_depth",
             "divergence_rate", "accept", "chains", "draws", "max_depth"}
# bench.py:350-463, every key its spline line can print
JAX_SPLINE_KEYS = {
    "dim", "num_bins", "layers", "hidden_dim", "chains", "draws",
    "train_steps_per_s_fused", "train_steps_per_s_xla", "final_kl",
    "ess_per_s_fused", "sample_s_fused", "accept_fused", "ess_per_s_xla",
    "sample_s_xla", "accept_xla", "kernel_speedup_sampling",
    "kernel_speedup_train", "sampling_error", "sampling_note"}


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=1e-10, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


def jax_bench_flow(layers, hidden, dim):
    """bench.py:79-87's flow, from the JAX package."""
    return JFlow(jd.DiagNormal(dim), jb.Chain(
        [jb.ActNorm(dim)] + [jb.AffineCoupling(dim, hidden_dim=hidden)
                             for _ in range(layers)]))


def bench_pair(layers=bench.LAYERS, hidden=bench.HIDDEN, dim=bench.DIM,
               seed=0):
    """(JAX flow, its float64 params, the port's build_flow with them):
    JAX's init, perturbed so ActNorm is no identity."""
    jflow = jax_bench_flow(layers, hidden, dim)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + 0.1 * rng.standard_normal(np.shape(a)),
        jflow.init(jax.random.PRNGKey(seed)))
    tflow = bench.build_flow(layers, hidden, dim, **F64)
    tparams.from_jax(tflow, p)
    return jflow, p, tflow


# ----------------------------------------------------------- build_flow
def test_build_flow_matches_jax():
    """The bench's flow at its widths (64-d, hidden 128, 2 couplings):
    forward, inverse and log-dets equal JAX's at rtol 1e-10."""
    jflow, p, tflow = bench_pair()
    x = np.random.default_rng(1).standard_normal((32, bench.DIM))
    jz, jplp, jld = jflow.forward(p, jnp.asarray(x))
    with torch.no_grad():
        tz, tplp, tld = tflow(t(x))
        tx, tld_inv = tflow.inverse(t(x))
    jx, jld_inv = jflow.inverse(p, jnp.asarray(x))
    for name, a, b in (("z", tz, jz), ("prior lp", tplp, jplp),
                       ("log-det", tld, jld), ("x", tx, jx),
                       ("inverse log-det", tld_inv, jld_inv)):
        close(a, b, msg=name)
    assert sum(p.numel() for p in tflow.parameters()) == sum(
        np.size(a) for a in jax.tree.leaves(p))


def test_gauss_target_is_jax_one():
    """GAUSS_PERM is JAX's permutation, so the secondary line's target
    equals IllConditionedGaussian(64, condition=1e4)."""
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                             bench.DIM))
    np.testing.assert_array_equal(np.asarray(bench.GAUSS_PERM), perm)
    jt = JIllCond(bench.DIM, condition=bench.GAUSS_CONDITION)
    close(bench.gauss_target("cpu").sigmas, jt.sigmas, rtol=1e-7, atol=0)


# ------------------------------------------------------- the timed phase
def test_sample_and_push_matches_jax():
    """One timed run (no warmup, a fixed step size and mass, then the
    push) on JAX's own draws equals JAX's run_hmc + flow.inverse."""
    from test_torch_hmc import jax_run_draws

    dim, chains, draws, step = 8, 32, 12, 0.4
    jflow, p, tflow = bench_pair(hidden=16, dim=dim, seed=3)
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((chains, dim))
    inv_m = rng.uniform(0.6, 1.5, dim)
    key = jax.random.PRNGKey(9)
    jres = j_run_hmc(key, j_pullback(jflow, p, JFunnel(dim)),
                     jnp.asarray(z0), draws, num_warmup=0, step_size=step,
                     inv_mass_diag=jnp.asarray(inv_m),
                     num_leapfrog=bench.LEAPFROG, batched_target=True)
    jx, _ = jflow.inverse(p, jres.samples.reshape(-1, dim))
    replay = jax_run_draws(key, chains, dim, 0, draws, 1)
    assert len(replay) == padded_length(draws)
    x, accept, checksum = bench.sample_and_push(
        tflow, NealsFunnel(dim), None, t(z0), draws, step, t(inv_m),
        bench.LEAPFROG, device="cpu", replay=replay)
    close(x.reshape(-1, dim), jx, msg="pushed draws")
    close(accept, jres.accept_rate, msg="accept rate")
    assert 0.0 < float(accept) < 1.0  # mixed accepts
    assert float(checksum) == float(x[-1].sum())


# ---------------------------------------------------------------- ESS
def test_ess_summary_matches_jax():
    """The line's ESS numbers, from the same seeded draws, equal JAX's
    estimators at rtol 1e-8: an even dim count (the median averages the
    two middle values), AR(1) chains of several correlations, and
    heavy-tailed coordinates."""
    rng = np.random.default_rng(0)
    n, m, dim = 80, 12, 6
    phi = np.linspace(0.0, 0.9, dim)
    xs = np.empty((n, m, dim))
    xs[0] = rng.standard_normal((m, dim))
    for i in range(1, n):
        xs[i] = phi * xs[i - 1] + rng.standard_normal((m, dim))
    xs[..., 1] = np.exp(xs[..., 1])
    xs[..., 4] = xs[..., 4] ** 3
    got = bench.ess_summary(t(xs))
    j = jnp.asarray(xs)
    bulk_x, bulk_x2 = j_bulk_ess_per_dim(j), j_bulk_ess_per_dim(j * j)
    hardest = int(jnp.argmin(bulk_x))
    want = dict(
        ess_min=jnp.minimum(jnp.min(bulk_x), jnp.min(bulk_x2)),
        ess_min_bulk_x=jnp.min(bulk_x), ess_min_bulk_x2=jnp.min(bulk_x2),
        ess_median_bulk_x=jnp.median(bulk_x),
        ess_min_raw_x=jnp.min(j_ess_per_dim(j)),
        ess_min_raw_x2=jnp.min(j_ess_per_dim(j * j)),
        ess_tail_hardest_coord=j_tail_ess(j[:, :, hardest]))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], rtol=1e-8, atol=0, msg=k)


# ------------------------------------------------- the lines, tiny sizes
@pytest.fixture
def transition_log(monkeypatch):
    """Records each bench run_hmc call as (num_warmup, transitions made),
    a transition being one call of the fused accept tail."""
    calls, count = [], [0]
    real_tail, real_run = thmc.accept_select_fused, bench.run_hmc

    def tail(*a, **k):
        count[0] += 1
        return real_tail(*a, **k)

    def run(*a, **k):
        before = count[0]
        res = real_run(*a, **k)
        calls.append((k["num_warmup"], count[0] - before))
        return res

    monkeypatch.setattr(thmc, "accept_select_fused", tail)
    monkeypatch.setattr(bench, "run_hmc", run)
    return calls


def test_neutra_ess_run_tiny(transition_log):
    """Every ported key; sample_s the fastest of three timed runs; each
    timed run exactly padded_length(draws) transitions, none of warmup."""
    dim, chains, draws = 8, 64, 8
    _, _, tflow = bench_pair(hidden=16, dim=dim, seed=5)
    out = bench.neutra_ess_run(
        tflow, NealsFunnel(dim), torch.Generator().manual_seed(0), "tiny",
        draws=draws, chains=chains, train_steps=20, train_batch=64,
        lr_warmup=5, device="cpu")
    assert HMC_KEYS <= set(out)
    assert len(out["sample_s_all"]) == bench.TIMED_RUNS
    assert out["sample_s"] == min(out["sample_s_all"])
    assert out["ess_cap"] == chains * draws
    assert out["samples"].shape == (draws, chains, dim)
    ess_min = min(out["ess_min_bulk_x"], out["ess_min_bulk_x2"])
    assert 0 < ess_min <= out["ess_cap"]
    # adaptation, the warm call, three timed runs
    assert transition_log == [(bench.WARMUP, padded_length(bench.WARMUP)
                               + 2)] + [(0, padded_length(draws))] * 4
    assert out["accept_launches_all"] == [0] * 3  # CPU: the plain tail
    assert all(p.requires_grad for p in tflow.parameters())
    assert set(bench.funnel_v_stats(out["samples"])) == {"v_mean", "v_var"}


def test_nuts_ess_line_tiny():
    _, _, tflow = bench_pair(hidden=16, dim=8, seed=6)
    out = bench.nuts_ess_line(tflow, NealsFunnel(8),
                              torch.Generator().manual_seed(1), chains=16,
                              draws=4, max_depth=3, device="cpu")
    assert set(out) == NUTS_KEYS
    assert out["sample_s"] == min(out["sample_s_all"])
    assert len(out["sample_s_all"]) == bench.TIMED_RUNS
    assert out["ess_cap"] == 16 * 4
    assert 0.0 < out["accept"] <= 1.0


def test_spline_flow_lines_tiny(transition_log):
    """Every key of bench.py's spline line is printed (the *_fused ones
    without the suffix) or listed under not_ported with its reason."""
    chains, draws = 16, 4
    out = bench.spline_flow_lines(
        torch.Generator().manual_seed(2), size=2, num_bins=4, hidden=8,
        chains=chains, draws=draws, leapfrog=2, train_steps=10,
        train_batch=16, lr_warmup=3, chunk=2, device="cpu")
    dropped = out["not_ported"]
    for key in JAX_SPLINE_KEYS:
        if key.endswith("_fused"):
            assert key[: -len("_fused")] in out, key
        else:
            assert (key in out) != (key in dropped), key
    assert set(dropped) <= JAX_SPLINE_KEYS
    assert all(isinstance(v, str) and v for v in dropped.values())
    assert out["dim"] == 6 and out["layers"] == 3
    assert out["train_steps_per_s"] > 0 and np.isfinite(out["final_kl"])
    assert transition_log[1:] == [(0, padded_length(draws))] * 4


def test_headline_line():
    funnel = dict(ess_per_s=123456.78, sample_s=1.5, chains=8192,
                  draws=1024, leapfrog=8, v_mean=0.01, v_var=8.9)
    line = bench.headline(funnel, {"n": 1}, {"g": 2}, {"s": 3},
                          {"mfu_vs_fp32_peak": 0.1}, "NVIDIA H100 80GB HBM3",
                          700.0)
    assert line["metric"] == "neutra_hmc_ess_per_s_funnel64"
    assert line["value"] == 123456.8 and line["unit"] == "ESS/s"
    assert line["vs_baseline"] == 0.1235
    d = line["detail"]
    assert "ess_per_s" not in d and d["sample_s"] == 1.5
    assert d["nuts_funnel"] == {"n": 1} and d["gaussian_secondary"] == {
        "g": 2} and d["spline_flow"] == {"s": 3}
    assert d["flow_layers"] == bench.LAYERS and d["mfu_vs_fp32_peak"] == 0.1
    assert d["device"] == "NVIDIA H100 80GB HBM3"
    assert d["power_limit_w"] == 700.0


def test_parse_power_limit():
    assert bench.parse_power_limit("NVIDIA H100 80GB HBM3, 700.00 W") \
        == 700.0
    assert bench.parse_power_limit("NVIDIA H100 80GB HBM3, 500.00 W") \
        == 500.0


# ---------------------------------------------------------------- mfu
def test_gemm_flops_counts_the_flows_products():
    """2 * B * sum(fan_in * fan_out) over the conditioners' linears, and
    no more than XLA's cost analysis of JAX's forward (which also counts
    the elementwise work)."""
    batch = 16
    jflow, p, tflow = bench_pair()
    x = np.random.default_rng(2).standard_normal((batch, bench.DIM))
    with torch.no_grad():
        got = mfu.gemm_flops(tflow, t(x))
    linears = [w for name, w in tflow.named_parameters()
               if name.rsplit(".", 1)[-1] in ("w1", "w2", "w3")]
    assert len(linears) == 3 * 4 * bench.LAYERS
    assert got == 2 * batch * sum(w.shape[0] * w.shape[1] for w in linears)
    cost = jax.jit(lambda xx: jflow.forward(p, xx)).lower(
        jnp.asarray(x)).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    assert got <= float(cost["flops"])


def test_peaks_are_the_h100_sxm_and_nothing_else():
    assert mfu.peak_flops("NVIDIA H100 80GB HBM3") == {"bf16": 989.4e12,
                                                       "fp32": 66.9e12}
    with pytest.raises(KeyError, match="no peak"):
        mfu.peak_flops("NVIDIA A100-SXM4-80GB")


def test_device_times_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        mfu.device_time_us(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.mfu_fwd_logdet(bench.build_flow(device="cpu"),
                             torch.Generator(), device="cpu")
