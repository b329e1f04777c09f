"""Parity of the port's HMC (adaptation, leapfrog, the chain-batched
transition, run_hmc, NeuTra) with the JAX package, in float64.

torch cannot reproduce JAX's threefry stream, so these tests replay JAX's
own key splits (mcmc/hmc.py's `draws`: split(key, 3) -> momentum, accept,
jitter keys) to get the raw draws JAX uses, and hand the same numbers to
the port through `draws=`. A transition then matches to rounding
(rtol 1e-10), and a whole run of a few hundred transitions to rtol 1e-8
where its dynamics do not amplify rounding (see test_run_hmc_matches_jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.mcmc import adaptation as jad
from normalizingflow_tpu.mcmc.hmc import (
    HMCState as JState,
    _batched_lp_grad,
    hmc_kernel_chainbatched,
    leapfrog as j_leapfrog,
    padded_length as j_padded_length,
    run_hmc as j_run_hmc,
)
from normalizingflow_tpu.mcmc.neutra import (
    pullback_logprob_batched as j_pullback,
)
from normalizingflow_tpu.targets import (
    IllConditionedGaussian as JIllCond,
    NealsFunnel as JFunnel,
)

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.mcmc import adaptation as tad
from normalizingflow_tpu_torch.mcmc import (
    batched_lp_grad,
    hmc_init,
    hmc_transition,
    leapfrog,
    neutra_hmc,
    padded_length,
    pullback_logprob_batched,
    run_hmc,
)
from normalizingflow_tpu_torch.targets import (
    IllConditionedGaussian,
    NealsFunnel,
)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=1e-10, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


@jax.jit
def _chain_draws(keys):
    """The raw per-chain draws of hmc_kernel_chainbatched for `keys`."""
    def one(k):
        k_mom, k_acc, k_eps = jax.random.split(k, 3)
        u = jax.random.uniform(k_eps, (), jnp.float64, -1.0, 1.0)
        ua = jax.random.uniform(k_acc, (), jnp.float64)
        return u, k_mom, ua
    return jax.vmap(one)(keys)


def jax_draws(key, chains, dim):
    """(jitter u (chains, 1), momentum normals (chains, dim), accept u)."""
    u, k_mom, ua = _chain_draws(jax.random.split(key, chains))
    normal = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
        k_mom)
    return t(u)[:, None], t(normal), t(ua)


def jax_run_draws(key, chains, dim, num_warmup, num_samples, thin):
    """Every transition's draws in the order JAX's run_hmc consumes them."""
    out = []
    if num_warmup > 0:
        k_warm, key = jax.random.split(key)
        for wk in jax.random.split(k_warm, j_padded_length(num_warmup)):
            out.append(jax_draws(wk, chains, dim))
    for sk in jax.random.split(key, j_padded_length(num_samples)):
        out.append(jax_draws(sk, chains, dim))
        if thin > 1:
            for sub in jax.random.split(jax.random.fold_in(sk, 1), thin - 1):
                out.append(jax_draws(sub, chains, dim))
    return out


# ------------------------------------------------------------ adaptation
@pytest.mark.parametrize("n", [0, 10, 100, 149, 150, 151, 500, 1000, 2345])
def test_warmup_schedule_matches_jax(n):
    for a, b in zip(tad.warmup_schedule(n), jad.warmup_schedule(n)):
        np.testing.assert_array_equal(a, b)


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    accepts = rng.uniform(0.2, 1.0, 40)
    js = jad.da_init(jnp.asarray(0.3, jnp.float64))
    ts = tad.da_init(torch.tensor(0.3, **F64))
    for i, a in enumerate(accepts):
        js = jad.da_update(js, jnp.asarray(a), 0.8)
        ts = tad.da_update(ts, torch.tensor(a, **F64), 0.8)
        if i == 20:  # a window end restarts the averaging
            js = jad.da_init(jad.da_step_size(js))
            ts = tad.da_init(tad.da_step_size(ts))
        for f in js._fields:
            close(getattr(ts, f), getattr(js, f), rtol=1e-14, atol=1e-15,
                  msg=f"{f} at {i}")
    close(tad.da_step_size(ts, averaged=True),
          jad.da_step_size(js, averaged=True), rtol=1e-14, atol=0)


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    jw, tw = jad.welford_init(5, jnp.float64), tad.welford_init(5, **F64)
    for i in range(6):
        x = rng.standard_normal((16, 5)) * np.arange(1, 6)
        jw = jad.welford_update_batch(jw, jnp.asarray(x))
        tw = tad.welford_update_batch(tw, t(x))
        for f in jw._fields:
            close(getattr(tw, f), getattr(jw, f), rtol=1e-14, atol=1e-15,
                  msg=f"{f} at {i}")
    for reg in (True, False):
        close(tad.welford_variance(tw, reg), jad.welford_variance(jw, reg),
              rtol=1e-14, atol=0)


# ------------------------------------------------------------- leapfrog
def test_leapfrog_matches_jax():
    dim, chains = 6, 16
    rng = np.random.default_rng(2)
    q0 = rng.standard_normal((chains, dim))
    q0[:, 0] *= 0.5
    mom = rng.standard_normal((chains, dim))
    eps = rng.uniform(0.05, 0.2, (chains, 1))
    inv_m = rng.uniform(0.5, 2.0, dim)
    jt, tt = JFunnel(dim), NealsFunnel(dim)
    jlg, tlg = _batched_lp_grad(jt.log_prob), batched_lp_grad(tt.log_prob)
    _, g0 = jlg(jnp.asarray(q0))
    jout = j_leapfrog(jlg, jnp.asarray(q0), jnp.asarray(mom), g0,
                      jnp.asarray(eps), 5, jnp.asarray(inv_m))
    tout = leapfrog(tlg, t(q0), t(mom), t(g0), t(eps), 5, t(inv_m))
    for name, a, b in zip(("q", "p", "lp", "g"), tout, jout):
        close(a, b, msg=name)


# ------------------------------------------------- one NeuTra transition
def neutra_pair(dim=8, hidden=16, seed=3):
    jflow = JFlow(jd.DiagNormal(dim), jb.Chain(
        [jb.ActNorm(dim)] + [jb.AffineCoupling(dim, hidden)
                             for _ in range(2)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(dim, **F64), tb.Chain(
        [tb.ActNorm(dim, **F64)] + [tb.AffineCoupling(dim, hidden, **F64)
                                    for _ in range(2)]))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + 0.1 * rng.standard_normal(np.shape(a)),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return jflow, p, tflow


def test_neutra_transition_matches_jax():
    """One chain-batched transition on the funnel's NeuTra pullback, with
    JAX's own eps, momentum and log_u; mixed accepts."""
    dim, chains, step, n_leap = 8, 64, 0.9, 4
    jflow, p, tflow = neutra_pair(dim)
    jlogp = j_pullback(jflow, p, JFunnel(dim))
    tlg = batched_lp_grad(pullback_logprob_batched(tflow, NealsFunnel(dim)))
    z0 = np.random.default_rng(4).standard_normal((chains, dim))
    inv_m = np.random.default_rng(5).uniform(0.6, 1.5, dim)

    lp0, g0 = _batched_lp_grad(jlogp)(jnp.asarray(z0))
    state = hmc_init(tlg, t(z0))
    close(state.log_prob, lp0, msg="init lp")
    close(state.grad, g0, msg="init grad")

    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, chains)
    jnew, jinfo = hmc_kernel_chainbatched(
        jlogp, step, n_leap, jnp.asarray(inv_m))(
            keys, JState(jnp.asarray(z0), lp0, g0))
    draws = jax_draws(key, chains, dim)
    tnew, tinfo = hmc_transition(tlg, state, draws, step, n_leap, t(inv_m))

    accepted = np.asarray(jinfo.accepted)
    assert 0 < accepted.sum() < chains  # mixed accepts exercised
    np.testing.assert_array_equal(tinfo.accepted.numpy(), accepted)
    close(tnew.position, jnew.position, msg="position")
    close(tnew.log_prob, jnew.log_prob, msg="log_prob")
    close(tnew.grad, jnew.grad, msg="grad")
    close(tinfo.accept_prob, jinfo.accept_prob, msg="accept_prob")
    close(tinfo.energy_change, jinfo.energy_change, rtol=1e-9, atol=1e-11,
          msg="energy_change")


# ------------------------------------------------------------- run_hmc
def _flat_jax(x):
    return 0.0 * jnp.sum(x, axis=-1)


def _flat_torch(x):
    return 0.0 * torch.sum(x, dim=-1)


@pytest.mark.parametrize("target,num_warmup,num_samples,thin", [
    # Flat density: every proposal is accepted with probability exactly 1,
    # so the run is deterministic given the draws -- the windowed mass
    # adaptation, its restarts and the padded warmup are compared exactly.
    ("flat", 160, 130, 1),
    # Ill-conditioned Gaussian: real accept/reject; the sampling phase is
    # padded from 130 to 256 transitions and accept_rate averages them
    # all. The warmup is kept short because dual averaging feeds step-size
    # rounding back into the trajectories and the two runs part after
    # ~40 adaptive transitions, though each transition agrees to 1e-15.
    ("gauss", 20, 130, 1),
    ("gauss", 0, 8, 3),      # no warmup, thinning
])
def test_run_hmc_matches_jax(target, num_warmup, num_samples, thin):
    """A whole run on JAX's draws: samples, accept_rate (over all
    padded_length transitions), adapted step size and mass."""
    dim, chains = 4, 16
    if target == "flat":
        jlogp, tlogp = _flat_jax, _flat_torch
    else:
        jt = JIllCond(dim, condition=100.0, seed=1)
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(1), dim))
        tt = IllConditionedGaussian(dim, perm, condition=100.0, **F64)
        close(tt.sigmas, jt.sigmas, rtol=1e-14, atol=0)
        jlogp, tlogp = jt.log_prob, tt.log_prob
    init = np.random.default_rng(6).standard_normal((chains, dim))
    key = jax.random.PRNGKey(8)
    kw = dict(num_warmup=num_warmup, step_size=0.3, num_leapfrog=4,
              thin=thin)
    jres = j_run_hmc(key, jlogp, jnp.asarray(init), num_samples,
                     batched_target=True, **kw)
    draws = jax_run_draws(key, chains, dim, num_warmup, num_samples, thin)
    tres = run_hmc(None, tlogp, t(init), num_samples, draws=draws,
                   device="cpu", **kw)
    assert len(draws) == (j_padded_length(num_warmup)
                          + j_padded_length(num_samples) * thin)
    for f in ("samples", "log_probs", "accept_rate", "step_size",
              "inv_mass_diag"):
        close(getattr(tres, f), getattr(jres, f), rtol=1e-8, atol=1e-10,
              msg=f)
    close(tres.final_state.position, jres.final_state.position, rtol=1e-8,
          atol=1e-10)
    if target == "flat":
        assert float(tres.accept_rate) == 1.0
        assert not torch.equal(tres.inv_mass_diag, torch.ones(dim, **F64))
    elif num_warmup:
        assert 0.3 < float(tres.accept_rate) < 1.0  # mixed accepts


def test_run_hmc_transition_count():
    """padded_length(warmup) + padded_length(draws) * thin transitions,
    each L gradient evaluations, plus one at the start."""
    calls = []

    def logprob(x):
        calls.append(1)
        return -0.5 * torch.sum(x * x, dim=-1)

    for n in (1, 128, 129, 300):
        assert padded_length(n) == j_padded_length(n)
    res = run_hmc(torch.Generator().manual_seed(0), logprob,
                  torch.zeros(8, 3, **F64), 130, num_warmup=20,
                  num_leapfrog=3, thin=2, device="cpu")
    assert len(calls) == 1 + 3 * (20 + 256 * 2)
    assert res.samples.shape == (130, 8, 3)


def test_run_hmc_ill_conditioned_moments():
    """Full port run on CPU with its own generator: per-dim variances
    within the tolerances tests/test_hmc.py uses for the JAX engine."""
    dim = 8
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), dim))
    target = IllConditionedGaussian(dim, perm, condition=1e3, **F64)
    gen = torch.Generator().manual_seed(0)
    init = target.sample(64, generator=gen)
    res = run_hmc(gen, target.log_prob, init, 300, num_warmup=800,
                  step_size=0.05, num_leapfrog=16, device="cpu")
    assert float(res.accept_rate) > 0.5
    samples = res.samples.reshape(-1, dim).numpy()
    ratio = samples.var(axis=0) / target.variances.numpy()
    assert np.all(ratio > 0.4) and np.all(ratio < 2.5), ratio
    np.testing.assert_allclose(samples.mean(axis=0) / np.sqrt(
        target.variances.numpy()), 0.0, atol=0.25)


def test_neutra_hmc_runs_on_cpu():
    """The NeuTra entry point: shapes, data-space push, and the flow's
    requires_grad flags restored."""
    dim = 8
    _, _, tflow = neutra_pair(dim)
    res = neutra_hmc(torch.Generator().manual_seed(0), tflow,
                     NealsFunnel(dim), 16, 12, num_warmup=10, device="cpu")
    assert res.samples_x.shape == res.samples_z.shape == (12, 16, dim)
    with torch.no_grad():
        x, _ = tflow.inverse(res.samples_z.reshape(-1, dim))
    close(res.samples_x.reshape(-1, dim), x, rtol=0, atol=0)
    assert 0.0 < float(res.accept_rate) <= 1.0
    assert all(p.requires_grad for p in tflow.parameters())


def test_hmc_rhat_and_ess():
    """tests/test_hmc.py test_hmc_rhat_and_ess on the port with its own
    generator: 16 chains started at 3 + N(0, 1) on a standard normal mix,
    R-hat < 1.1 and min ESS > 200 over 6400 draws."""
    from normalizingflow_tpu_torch.estimators.ess import (
        min_ess,
        potential_scale_reduction,
    )

    gen = torch.Generator().manual_seed(5)
    init = 3.0 + torch.randn(16, 2, generator=gen, **F64)
    res = run_hmc(gen, lambda x: -0.5 * torch.sum(x * x, dim=-1), init, 400,
                  num_warmup=300, step_size=0.3, num_leapfrog=8,
                  device="cpu")
    rhat = potential_scale_reduction(res.samples).numpy()
    assert np.all(rhat < 1.1), rhat
    ess = float(min_ess(res.samples))
    assert ess > 200.0, ess
