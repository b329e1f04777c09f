"""Parity of the port's NUTS (mcmc/nuts.py) with the JAX package, in float64.

torch cannot reproduce JAX's threefry stream, so these tests rebuild the
raw draws that `jax.vmap(nuts_kernel(...))` takes from each chain's key
(the momentum key and, for each depth, the direction, subtree and take keys
of `nuts.py:214`, `:240` and the subtree's per-leaf proposal keys of
`:124`) and hand the same numbers to the port through `draws`. One
transition, and short `run_nuts` runs, then match JAX at rtol 1e-10: on an
anisotropic Gaussian and on the NeuTra pullback of a small SplineCoupling
flow, whose RQS plain twin and its VJP run under NUTS. A batch with a chain
in a NaN region leaves the other chains bit for bit as they are without it.
The statistical tests of tests/test_nuts_smc.py and the Stan eight-schools
check run on the port alone, with the same bands.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.mcmc import nuts as jnuts
from normalizingflow_tpu.mcmc.hmc import HMCState as JState
from normalizingflow_tpu.mcmc.hmc import padded_length as j_padded_length
from normalizingflow_tpu.mcmc.neutra import pullback_logprob as j_pullback
from normalizingflow_tpu.targets import NealsFunnel as JFunnel

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.mcmc import (
    batched_lp_grad,
    hmc_init,
    nuts_transition,
    padded_length,
    pullback_logprob_batched,
    run_nuts,
)
from normalizingflow_tpu_torch.mcmc import nuts as tnuts
from normalizingflow_tpu_torch.targets import NealsFunnel

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
RTOL, ATOL = 1e-10, 1e-12  # the packages differ in the order of sums only


def t(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


# ------------------------------------------------------------ JAX's draws
def _chain_draws(key, dim, max_depth):
    """One chain's raw draws, split from its key as nuts_kernel splits it."""
    k_mom, key = jax.random.split(key)
    normal = jax.random.normal(k_mom, (dim,), jnp.float64)
    dirs, takes, leaves = [], [], []
    for d in range(max_depth):
        key, k_dir, k_sub, k_take = jax.random.split(key, 4)
        dirs.append(jax.random.bernoulli(k_dir))
        takes.append(jax.random.uniform(k_take, (), jnp.float64))

        def leaf(k, _):
            k, k_prop = jax.random.split(k)
            return k, jax.random.uniform(k_prop, (), jnp.float64)

        leaves.append(jax.lax.scan(leaf, k_sub, None, length=2 ** d)[1])
    return normal, jnp.stack(dirs), jnp.stack(takes), leaves


@partial(jax.jit, static_argnums=(1, 2, 3))
def _draws(key, chains, dim, max_depth):
    return jax.vmap(lambda k: _chain_draws(k, dim, max_depth))(
        jax.random.split(key, chains))


class TableDraws:
    """One transition's draws from tables (the draws interface of
    nuts.TransitionDraws)."""

    def __init__(self, normal, dirs, takes, leaves):
        self.normal, self.dirs, self.takes, self.leaves = (
            normal, dirs, takes, leaves)

    @classmethod
    def from_jax(cls, key, chains, dim, max_depth):
        normal, dirs, takes, leaves = _draws(key, chains, dim, max_depth)
        return cls(t(normal), t(dirs), t(takes), [t(u) for u in leaves])

    @classmethod
    def from_torch(cls, gen, chains, dim, max_depth):
        kw = dict(generator=gen, **F64)
        return cls(torch.randn(chains, dim, **kw),
                   torch.rand(chains, max_depth, **kw) < 0.5,
                   torch.rand(chains, max_depth, **kw),
                   [torch.rand(chains, 2 ** d, **kw)
                    for d in range(max_depth)])

    def chains(self, sel):
        return TableDraws(self.normal[sel], self.dirs[sel], self.takes[sel],
                          [u[sel] for u in self.leaves])

    def momentum(self):
        return self.normal

    def direction(self, depth):
        return self.dirs[:, depth]

    def take(self, depth):
        return self.takes[:, depth]

    def leaf(self, depth, n):
        return self.leaves[depth][:, n]


def jax_run_draws(key, chains, dim, max_depth, num_warmup, num_samples):
    """Every transition's draws in the order JAX's run_nuts consumes them."""
    keys = []
    if num_warmup > 0:
        k_warm, key = jax.random.split(key)
        keys += list(jax.random.split(k_warm, j_padded_length(num_warmup)))
    keys += list(jax.random.split(key, j_padded_length(num_samples)))
    return [TableDraws.from_jax(k, chains, dim, max_depth) for k in keys]


# ------------------------------------------------------------- targets
VARIANCES = np.array([0.04, 0.3, 1.0, 4.0, 9.0])


def gauss_pair():
    """(per-chain JAX log-prob, batched port log-prob, dim)."""
    var = jnp.asarray(VARIANCES)
    tvar = t(VARIANCES)
    return (lambda x: -0.5 * jnp.sum(x * x / var),
            lambda x: -0.5 * torch.sum(x * x / tvar, dim=-1),
            len(VARIANCES))


SIZE, SPACE, K, B, HIDDEN = 4, 3, 8, 3.0, 16


def spline_pair(seed=3):
    """The NeuTra pullback of 2 x SplineCoupling (4 particles x 3, 8 bins,
    B = 3) on NealsFunnel(12), in both packages, with shared params."""
    dim = SIZE * SPACE
    kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN)
    jflow = JFlow(jd.DiagNormal(dim), jb.Chain(
        [jb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw) for a in range(2)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(dim, **F64), tb.Chain(
        [tb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw, **F64)
         for a in range(2)]))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.3 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return (j_pullback(jflow, p, JFunnel(dim)),
            pullback_logprob_batched(tflow, NealsFunnel(dim)), dim)


PAIRS = {"gauss": gauss_pair, "spline": spline_pair}


# ---------------------------------------------------------------- tests
def test_slot_arithmetic_matches_jax():
    n = np.arange(2 ** 9, dtype=np.int32)
    pc = np.asarray(jnuts._popcount(jnp.asarray(n)))
    to = np.asarray(jnuts._trailing_ones(jnp.asarray(n)))
    assert [tnuts.popcount(int(i)) for i in n] == pc.tolist()
    assert [tnuts.trailing_ones(int(i)) for i in n] == to.tolist()


@pytest.mark.parametrize("kind,step,max_depth", [
    ("gauss", 0.35, 7), ("spline", 0.3, 6)])
def test_transition_matches_jax(kind, step, max_depth):
    """One transition of 64 chains against jax.vmap(nuts_kernel): the new
    state and every NUTSInfo field, across mixed depths and both
    directions."""
    jlogp, tlogp, dim = PAIRS[kind]()
    chains = 64
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((chains, dim))
    inv_m = rng.uniform(0.6, 1.5, dim)
    jstate = jax.vmap(lambda q: JState(q, *jax.value_and_grad(jlogp)(q)))(
        jnp.asarray(z0))
    lp_grad = batched_lp_grad(tlogp)
    state = hmc_init(lp_grad, t(z0))
    close(state.log_prob, jstate.log_prob, msg="init lp")
    close(state.grad, jstate.grad, msg="init grad")

    key = jax.random.PRNGKey(7)
    jnew, jinfo = jax.vmap(jnuts.nuts_kernel(
        jlogp, step, jnp.asarray(inv_m), max_depth))(
            jax.random.split(key, chains), jstate)
    draws = TableDraws.from_jax(key, chains, dim, max_depth)
    new, info = nuts_transition(lp_grad, state, draws, step, t(inv_m),
                                max_depth)

    depths = np.asarray(jinfo.depth)
    assert len(set(depths.tolist())) >= 3, depths  # mixed depths
    np.testing.assert_array_equal(info.depth.numpy(), depths)
    np.testing.assert_array_equal(info.n_leapfrog.numpy(),
                                  np.asarray(jinfo.n_leapfrog))
    np.testing.assert_array_equal(info.diverged.numpy(),
                                  np.asarray(jinfo.diverged))
    close(new.position, jnew.position, msg="position")
    close(new.log_prob, jnew.log_prob, msg="log_prob")
    close(new.grad, jnew.grad, msg="grad")
    close(info.accept_prob, jinfo.accept_prob, msg="accept_prob")
    moved = np.any(np.asarray(jnew.position) != z0, axis=1)
    assert moved.any()


@pytest.mark.parametrize("kind,num_warmup,num_samples", [
    ("gauss", 0, 30),
    # Dual averaging feeds step-size rounding back into the trajectories,
    # and runs part after ~40 adaptive transitions (ROADMAP Queue 3).
    ("gauss", 40, 10),
    ("spline", 0, 12),
])
def test_run_nuts_matches_jax(kind, num_warmup, num_samples):
    """A whole run on JAX's draws: samples, log-probs, the rates, the
    adapted step size and mass, the final state."""
    jlogp, tlogp, dim = PAIRS[kind]()
    chains, max_depth = 16, 5
    init = np.random.default_rng(6).standard_normal((chains, dim))
    key = jax.random.PRNGKey(8)
    kw = dict(num_warmup=num_warmup, step_size=0.4, max_depth=max_depth)
    jres = jnuts.run_nuts(key, jlogp, jnp.asarray(init), num_samples, **kw)
    draws = jax_run_draws(key, chains, dim, max_depth, num_warmup,
                          num_samples)
    tres = run_nuts(None, tlogp, t(init), num_samples, draws=draws,
                    device="cpu", **kw)
    for f in ("samples", "log_probs", "accept_rate", "step_size",
              "inv_mass_diag", "mean_depth", "divergence_rate"):
        close(getattr(tres, f), getattr(jres, f), msg=f)
    close(tres.final_state.position, jres.final_state.position)
    assert 1.0 < float(tres.mean_depth) < max_depth


def test_run_nuts_runs_and_divides_by_padded_length():
    """On a flat target with max_depth 1 a transition is one gradient, so
    the target counts transitions: 1 + padded_length(warmup) +
    padded_length(draws). The target turns NaN for the pad transitions of
    the sampling phase, which then diverge with accept 0: accept_rate is
    num_samples / padded count and divergence_rate the rest, while
    mean_depth stays 1 (every transition has depth 1)."""
    num_warmup, num_samples = 130, 129
    n_warm, n_run = padded_length(num_warmup), padded_length(num_samples)
    assert (n_warm, n_run) == (j_padded_length(num_warmup),
                               j_padded_length(num_samples)) == (256, 256)
    calls = []

    def logprob(x):
        calls.append(1)
        flat = 0.0 * torch.sum(x, dim=-1)
        return flat if len(calls) <= 1 + n_warm + num_samples \
            else flat + torch.nan

    res = run_nuts(torch.Generator().manual_seed(0), logprob,
                   torch.zeros(4, 2, **F64), num_samples,
                   num_warmup=num_warmup, step_size=0.3, max_depth=1,
                   device="cpu")
    assert len(calls) == 1 + n_warm + n_run
    assert float(res.accept_rate) == num_samples / n_run
    assert float(res.divergence_rate) == (n_run - num_samples) / n_run
    assert float(res.mean_depth) == 1.0
    assert res.samples.shape == (num_samples, 4, 2)
    assert bool(torch.isfinite(res.samples).all())


def _nan_logprob(x):
    """test_nuts_survives_nan_energies' target: NaN where x0 >= 2."""
    safe = -0.5 * torch.sum(x * x, dim=-1)
    return torch.where(x[:, 0] < 2.0, safe, torch.nan)


def test_nan_chain_leaves_other_chains_unchanged():
    """Chain 0 starts at the NaN region's edge and is kicked into it by its
    first draws; every other chain's state and info are bit for bit those
    of a batch without it, on the same draws, over 15 transitions."""
    chains, dim, max_depth, steps = 8, 3, 6, 15
    gen = torch.Generator().manual_seed(3)
    init = 0.5 * torch.randn(chains, dim, generator=gen, **F64)
    init[0, 0] = 1.9
    draws = [TableDraws.from_torch(gen, chains, dim, max_depth)
             for _ in range(steps)]
    draws[0].normal[0, 0] = 3.0
    draws[0].dirs[0, 0] = True
    lp_grad = batched_lp_grad(_nan_logprob)
    inv_m = torch.ones(dim, **F64)
    full = hmc_init(lp_grad, init)
    rest = hmc_init(lp_grad, init[1:].clone())
    diverged = []
    for d in draws:
        full, info = nuts_transition(lp_grad, full, d, 0.5, inv_m, max_depth)
        rest, rinfo = nuts_transition(lp_grad, rest, d.chains(slice(1, None)),
                                      0.5, inv_m, max_depth)
        diverged.append(bool(info.diverged[0]))
        for a, b in zip((*full, *info), (*rest, *rinfo)):
            assert torch.equal(a[1:], b)
    assert diverged[0]
    assert bool(torch.isfinite(full.position).all())


# --------------------------------------- the port's statistical twins
def _run(logprob, init, seed, **kw):
    return run_nuts(torch.Generator().manual_seed(seed), logprob, init,
                    device="cpu", **kw)


def _normal(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def test_nuts_standard_normal():
    dim = 4
    init = torch.randn(32, dim, generator=torch.Generator().manual_seed(0),
                       **F64)
    res = _run(_normal, init, 1, num_samples=500, num_warmup=300,
               step_size=0.2, max_depth=6)
    s = res.samples.reshape(-1, dim).numpy()
    assert float(res.divergence_rate) < 0.01
    assert 1.0 <= float(res.mean_depth) <= 6.0
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(s.var(axis=0), 1.0, atol=0.12)


def test_nuts_adapts_to_anisotropy():
    variances = torch.tensor([0.04, 1.0, 9.0], **F64)
    init = torch.randn(32, 3, generator=torch.Generator().manual_seed(2),
                       **F64)
    res = _run(lambda x: -0.5 * torch.sum(x * x / variances, dim=-1), init,
               3, num_samples=500, num_warmup=600, step_size=0.1,
               max_depth=8)
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.var(axis=0), variances.numpy(), rtol=0.35)
    assert float(res.divergence_rate) < 0.01


def test_nuts_survives_nan_energies():
    """A NaN leaf energy contributes weight 0 and accept 0 and does not
    poison the adapted step size."""
    res = _run(_nan_logprob, torch.zeros(32, 3, **F64), 11,
               num_samples=300, num_warmup=300, step_size=0.5, max_depth=6)
    assert np.isfinite(float(res.accept_rate))
    assert np.isfinite(float(res.step_size)) and float(res.step_size) > 0
    assert float(res.accept_rate) > 0.3
    assert float(res.divergence_rate) < 0.9
    assert float(res.mean_depth) > 1.0
    s = res.samples.numpy()
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s[..., 1:].mean(), 0.0, atol=0.1)


def test_nuts_explores_from_bad_init():
    res = _run(_normal, torch.full((16, 2), 6.0, **F64), 4,
               num_samples=300, num_warmup=300, step_size=0.5, max_depth=8)
    s = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.15)


EIGHT_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
EIGHT_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def eight_schools_logprob(x):
    """Non-centered eight schools, batched: mu ~ N(0, 5), tau ~
    HalfCauchy(5) through log_tau with its Jacobian, z ~ N(0, 1)^8, y ~
    N(mu + tau * z, sigma)."""
    y = torch.tensor(EIGHT_Y, dtype=x.dtype, device=x.device)
    sig = torch.tensor(EIGHT_SIGMA, dtype=x.dtype, device=x.device)
    mu, log_tau, z = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    lp = -0.5 * (mu / 5.0) ** 2
    lp = lp + (np.log(2.0 / (np.pi * 5.0)) - torch.log1p((tau / 5.0) ** 2)
               + log_tau)
    lp = lp - 0.5 * torch.sum(z * z, dim=-1)
    return lp + torch.sum(
        -0.5 * ((y - (mu[:, None] + tau[:, None] * z)) / sig) ** 2, dim=-1)


def eight_schools_bands(samples, res):
    """tests/test_nuts_smc.py's Stan/posteriordb bands; a list of the
    (name, value, ok) of each."""
    s = samples.reshape(-1, 10)
    mu, tau = s[:, 0], np.exp(s[:, 1])
    theta1 = s[:, 0] + tau * s[:, 2]
    return [
        ("mu mean", mu.mean(), abs(mu.mean() - 4.40) < 0.6),
        ("mu sd", mu.std(), abs(mu.std() - 3.3) < 0.7),
        ("tau mean", tau.mean(), abs(tau.mean() - 3.6) < 0.8),
        ("tau sd", tau.std(), abs(tau.std() - 3.2) < 0.9),
        ("theta1 mean", theta1.mean(), abs(theta1.mean() - 6.25) < 0.9),
        ("mean depth", float(res.mean_depth),
         1.8 <= float(res.mean_depth) <= 4.0),
        ("divergence", float(res.divergence_rate),
         float(res.divergence_rate) < 0.02),
        ("accept", float(res.accept_rate),
         0.7 <= float(res.accept_rate) <= 0.92),
    ]


def test_nuts_eight_schools_vs_stan_reference():
    init = 0.1 * torch.randn(48, 10, generator=torch.Generator()
                             .manual_seed(0), **F64)
    res = _run(eight_schools_logprob, init, 1, num_samples=800,
               num_warmup=800, step_size=0.1, max_depth=8)
    bands = eight_schools_bands(res.samples.numpy(), res)
    assert all(ok for _, _, ok in bands), bands
