"""Parity of the port's SMC (mcmc/smc.py) with the JAX package, in float64.

Systematic resampling and the ESS of log-weights match JAX's at 1e-12 on
JAX's own offset u0. A whole `run_smc` replays JAX's draws: each stage's
key splits into the resampling key (u0) and the mutation keys, and each
mutation step's per-particle keys give the momentum, accept and jitter
draws of `hmc_kernel` (mcmc/hmc.py), which the port's chain-batched
`hmc_transition` consumes. log_evidence, n_stages, final_accept and the
particles then match at rtol 1e-9, and `flow_smc` on a two-layer SplineAR
carried across by `params.from_jax`, with JAX's latents injected, matches
JAX's `flow_smc`. The statistical tests of tests/test_nuts_smc.py run on
the port alone, with the same bands.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.mcmc import smc as jsmc
from normalizingflow_tpu.targets.phi4 import Phi4Lattice as JPhi4

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.mcmc import (
    ess_from_log_weights,
    flow_smc,
    run_smc,
    systematic_resampling,
)
from normalizingflow_tpu_torch.targets import Phi4Lattice

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


# ------------------------------------------------------------ JAX's draws
@jax.jit
def _chain_draws(keys):
    """hmc_kernel's raw draws for each particle's key."""
    def one(k):
        k_mom, k_acc, k_eps = jax.random.split(k, 3)
        u = jax.random.uniform(k_eps, (), jnp.float64, -1.0, 1.0)
        ua = jax.random.uniform(k_acc, (), jnp.float64)
        return u, k_mom, ua
    return jax.vmap(one)(keys)


def hmc_draws(key, n, dim):
    u, k_mom, ua = _chain_draws(jax.random.split(key, n))
    normal = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
        k_mom)
    return t(u)[:, None], t(normal), t(ua)


def smc_draws(key, n, dim, n_mutation_steps):
    """run_smc's draws in the order it consumes them, stage after stage:
    the resampling offset, then each mutation step's draws."""
    while True:
        key, k_resample, k_mutate = jax.random.split(key, 3)
        yield t(jax.random.uniform(k_resample, (), jnp.float64))
        for k in jax.random.split(k_mutate, n_mutation_steps):
            yield hmc_draws(k, n, dim)


# ------------------------------------------------------------ resampling
def _end_of_cdf_weights():
    """Log-weights whose float64 CDF ends below 1, so that the last point,
    (u0 + n - 1) / n with u0 near 1, lies past it and is clipped to n - 1."""
    rng = np.random.default_rng(0)
    for _ in range(1000):
        lw = rng.standard_normal(10)
        if float(torch.cumsum(torch.softmax(t(lw), 0), 0)[-1]) < 1.0:
            return lw
    raise AssertionError("no such weights")


@pytest.mark.parametrize("case", ["random", "degenerate", "end_of_cdf"])
def test_systematic_resampling_matches_jax(case):
    if case == "random":
        lw, n = np.random.default_rng(1).standard_normal(50) * 2.0, None
        key = jax.random.PRNGKey(3)
    elif case == "degenerate":  # tests/test_nuts_smc.py:98-106's weights
        lw, n = np.array([0.0] + [-1e9] * 99), 64
        key = jax.random.PRNGKey(4)
    else:
        lw, n = _end_of_cdf_weights(), None
        key = None
    if key is None:
        u0 = np.nextafter(1.0, 0.0)
        want = None
    else:
        u0 = float(jax.random.uniform(key, (), jnp.float64))
        want = np.asarray(jsmc.systematic_resampling(key, jnp.asarray(lw),
                                                     n))
    got = systematic_resampling(t(lw), n, u0=torch.tensor(u0, **F64))
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "degenerate":
        assert (got == 0).all()
    if case == "end_of_cdf":
        assert int(got[-1]) == len(lw) - 1
        # the unclipped search runs past the end
        cdf = torch.cumsum(torch.softmax(t(lw), 0), 0)
        assert int(torch.searchsorted(cdf, torch.tensor(
            (u0 + len(lw) - 1) / len(lw), **F64))) == len(lw)


@pytest.mark.parametrize("kind", ["random", "uniform", "degenerate"])
def test_ess_from_log_weights_matches_jax(kind):
    lw = {"random": np.random.default_rng(2).standard_normal(200) * 3.0,
          "uniform": np.zeros(100),
          "degenerate": np.array([0.0] + [-1e9] * 99)}[kind]
    got = float(ess_from_log_weights(t(lw)))
    close(got, float(jsmc.ess_from_log_weights(jnp.asarray(lw))),
          rtol=1e-12)
    if kind != "random":
        close(got, {"uniform": 100.0, "degenerate": 1.0}[kind], rtol=1e-12)


# ----------------------------------------------------------- run_smc
def test_run_smc_matches_jax():
    """The Gaussian shift N(0, 1)^3 -> N(1.5, 1)^3 with 256 particles, on
    JAX's draws: every stage's tempering, resampling and mutation."""
    dim, n, mu = 3, 256, 1.5
    kw = dict(n_mutation_steps=3, num_leapfrog=4, step_size=0.5)
    x0 = np.random.default_rng(5).standard_normal((n, dim))
    key = jax.random.PRNGKey(7)
    jres = jsmc.run_smc(
        key, jnp.asarray(x0), lambda x: -0.5 * jnp.sum(x * x, axis=-1),
        lambda x: -0.5 * jnp.sum((x - mu) ** 2, axis=-1), **kw)
    tres = run_smc(
        None, t(x0), lambda x: -0.5 * torch.sum(x * x, dim=-1),
        lambda x: -0.5 * torch.sum((x - mu) ** 2, dim=-1),
        draws=smc_draws(key, n, dim, kw["n_mutation_steps"]), device="cpu",
        **kw)
    assert tres.n_stages == int(jres.n_stages) >= 3
    close(tres.log_evidence, jres.log_evidence, rtol=1e-9, atol=1e-12)
    close(tres.final_accept, jres.final_accept, rtol=1e-9)
    close(tres.particles, jres.particles, rtol=1e-9, atol=1e-12)


def test_flow_smc_matches_jax():
    """flow_smc on a 4 x 4 phi^4 lattice with a 2 x SplineAR(16, K = 8)
    proposal: JAX's latents are injected, then JAX's run draws."""
    lat, dim, n = 4, 16, 128
    kw = dict(num_bins=8, tail_bound=6.0, hidden_dim=8, periodic=False)
    jflow = JFlow(jd.DiagNormal(dim),
                  jb.Chain([jb.SplineAR(dim, **kw) for _ in range(2)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(dim, **F64), tb.Chain(
        [tb.SplineAR(dim, **kw, **F64) for _ in range(2)]))
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(0)))
    tparams.from_jax(tflow, p)
    jtarget = JPhi4(lat, kappa=0.3, lam=0.022)
    ttarget = Phi4Lattice(lat, kappa=0.3, lam=0.022)
    smc_kw = dict(n_mutation_steps=2, num_leapfrog=3, step_size=0.2,
                  max_stages=8)
    key = jax.random.PRNGKey(11)
    jres = jsmc.flow_smc(key, jflow, p, jtarget, n, **smc_kw)
    k_init, k_run = jax.random.split(key)
    z = t(jflow.sample(p, k_init, n)[2])
    tres = flow_smc(None, tflow, ttarget, n, z=z, device="cpu",
                    draws=smc_draws(k_run, n, dim, 2), **smc_kw)
    assert tres.n_stages == int(jres.n_stages) >= 2
    close(tres.log_evidence, jres.log_evidence, rtol=1e-9, atol=1e-12)
    close(tres.final_accept, jres.final_accept, rtol=1e-9)
    close(tres.particles, jres.particles, rtol=1e-9, atol=1e-12)
    assert all(q.requires_grad for q in tflow.parameters())


# --------------------------------------- the port's statistical twins
def test_systematic_resampling_unbiased():
    gen = torch.Generator().manual_seed(5)
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4], **F64))
    counts = np.zeros(4)
    for _ in range(200):
        idx = systematic_resampling(log_w, 100, generator=gen)
        counts += np.bincount(idx.numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4],
                               atol=0.01)


def test_smc_gaussian_shift_evidence():
    """Anneal N(0,1)^4 -> N(1.5,1)^4: log Z = 0, target moments."""
    dim, n, mu = 4, 2048, 1.5
    gen = torch.Generator().manual_seed(6)
    res = run_smc(gen, torch.randn(n, dim, generator=gen, **F64),
                  lambda x: -0.5 * torch.sum(x * x, dim=-1),
                  lambda x: -0.5 * torch.sum((x - mu) ** 2, dim=-1),
                  n_mutation_steps=4, num_leapfrog=5, step_size=0.5,
                  device="cpu")
    p = res.particles.numpy()
    assert res.n_stages >= 2
    np.testing.assert_allclose(p.mean(axis=0), mu, atol=0.15)
    np.testing.assert_allclose(p.var(axis=0), 1.0, atol=0.2)
    assert abs(float(res.log_evidence)) < 0.25


def test_smc_estimates_evidence_ratio():
    """Anneal N(0,1) -> 3 N(0,1): log Z = log 3."""
    dim, n = 2, 4096
    gen = torch.Generator().manual_seed(8)
    res = run_smc(gen, torch.randn(n, dim, generator=gen, **F64),
                  lambda x: -0.5 * torch.sum(x * x, dim=-1),
                  lambda x: math.log(3.0) - 0.5 * torch.sum(x * x, dim=-1),
                  n_mutation_steps=2, num_leapfrog=4, step_size=0.5,
                  device="cpu")
    np.testing.assert_allclose(float(res.log_evidence), math.log(3.0),
                               atol=0.05)
