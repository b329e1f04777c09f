"""The JAX package's per-point target convention in the port, in float64.

A per-point target maps one point (dim,) to a scalar; JAX's run_hmc takes
it by default (`batched_target=False`, hmc_kernel_batched) and run_nuts
only so. The port's default is the batched form, and a per-point target
handed to it must raise, not sample the wrong law. Under
`batched_target=False` the port vmaps the target's gradient with
torch.func (mcmc/hmc.py pointwise_lp_grad), and the RQS Function's vmap
rules (ops/rqs.py) keep a spline flow at one kernel call an evaluation.

The same seeds and inputs go through both packages, with JAX's raw draws
replayed (tests/test_torch_hmc.py, tests/test_torch_nuts.py): rtol 1e-10
against JAX, and 1e-12 between the port's per-point and batched forms.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.bijectors import mlp as jmlp
from normalizingflow_tpu.mcmc import hmc as jhmc
from normalizingflow_tpu.mcmc import nuts as jnuts
from normalizingflow_tpu.mcmc.neutra import pullback_logprob as j_pullback
from normalizingflow_tpu.targets import NealsFunnel as JFunnel

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.bijectors import MLP, mlp_apply, mlp_init
from normalizingflow_tpu_torch.mcmc import (
    batched_lp_grad,
    hmc_init,
    hmc_kernel,
    hmc_kernel_batched,
    hmc_kernel_chainbatched,
    nuts_kernel,
    nuts_transition,
    pointwise_lp_grad,
    pullback_logprob,
    pullback_logprob_batched,
    run_hmc,
    run_nuts,
)
from normalizingflow_tpu_torch.mcmc.neutra import frozen
from normalizingflow_tpu_torch.ops import rqs as ops_rqs
from normalizingflow_tpu_torch.targets import NealsFunnel

from test_torch_hmc import jax_draws
from test_torch_hmc import jax_run_draws as hmc_run_draws
from test_torch_nuts import TableDraws
from test_torch_nuts import jax_run_draws as nuts_run_draws

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
RTOL, ATOL = 1e-10, 1e-12     # against JAX
SELF = dict(rtol=1e-12, atol=1e-12)  # per-point against batched, the port
# A whole run against JAX's, as tests/test_torch_hmc.py holds its runs: dual
# averaging feeds the step size's last-bit rounding back into the
# trajectories, so a run of a few hundred transitions parts by more than
# one transition (1e-15) does.
RUN = dict(rtol=1e-8, atol=1e-10)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=RTOL, atol=ATOL, msg=""):
    actual, expected = (a.detach().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a) for a in (actual, expected))
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol,
                               err_msg=msg)


def same_state(a, b, msg=""):
    for f in ("position", "log_prob", "grad"):
        close(getattr(a, f), getattr(b, f), **SELF, msg=f"{msg} {f}")


# --------------------------------------------------------------- targets
# The per-point targets of the JAX tests: tests/test_nuts_smc.py:18 and
# tests/test_hmc.py:18 (standard normal), tests/test_hmc.py:33 and
# tests/test_nuts_smc.py:33 (anisotropic), tests/test_hmc_pallas.py:63
# (quartic). Each is (JAX per point, port per point, port batched).
ANISO_HMC = np.array([0.01, 1.0, 25.0])
ANISO_NUTS = np.array([0.04, 1.0, 9.0])
GAUSS = np.array([0.25, 1.0, 4.0, 9.0])


def gauss_targets(var):
    jv, tv = jnp.asarray(var), t(var)
    return (lambda x: -0.5 * jnp.sum(x * x / jv),
            lambda x: -0.5 * torch.sum(x * x / tv),
            lambda x: -0.5 * torch.sum(x * x / tv, dim=-1))


def quartic_targets():
    return (lambda x: -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x ** 4),
            lambda x: -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x ** 4),
            lambda x: (-0.5 * torch.sum(x * x, dim=-1)
                       - 0.1 * torch.sum(x ** 4, dim=-1)))


PER_POINT = {
    "standard_normal": (lambda x: -0.5 * torch.sum(x * x), 4),
    "anisotropic": (gauss_targets(ANISO_HMC)[1], 3),
    "quartic": (quartic_targets()[1], 5),
}
SAMPLERS = {"run_hmc": run_hmc, "run_nuts": run_nuts}


# ------------------------------------------------------------ the repair
@pytest.mark.parametrize("target", sorted(PER_POINT))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_default_rejects_per_point_target(sampler, target):
    """JAX's per-point targets on the port's default batched_target=True
    give one scalar for the whole batch, whose gradient mixes the chains
    (run_nuts sampled a far too narrow law with it, without a word): a
    ValueError that names the flag."""
    logprob, dim = PER_POINT[target]
    init = torch.randn(16, dim, generator=torch.Generator().manual_seed(0),
                       **F64)
    with pytest.raises(ValueError, match="batched_target=False"):
        SAMPLERS[sampler](torch.Generator().manual_seed(1), logprob, init,
                          4, num_warmup=0, device="cpu")


def _hmc_standard_normal():
    # tests/test_hmc.py test_hmc_standard_normal_moments
    gen = torch.Generator().manual_seed(0)
    init = torch.randn(64, 4, generator=gen, **F64)
    res = run_hmc(gen, PER_POINT["standard_normal"][0], init, 1000,
                  num_warmup=300, step_size=0.2, num_leapfrog=8,
                  device="cpu", batched_target=False)
    s = res.samples.reshape(-1, 4).numpy()
    assert 0.5 < float(res.accept_rate) <= 1.0
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(s.var(axis=0), 1.0, atol=0.12)


def _hmc_anisotropic():
    # tests/test_hmc.py test_hmc_adapts_step_size_and_mass
    gen = torch.Generator().manual_seed(2)
    init = torch.randn(64, 3, generator=gen, **F64) * t(np.sqrt(ANISO_HMC))
    res = run_hmc(gen, gauss_targets(ANISO_HMC)[1], init, 400,
                  num_warmup=600, step_size=0.1, num_leapfrog=8,
                  device="cpu", batched_target=False)
    ratio = res.inv_mass_diag.numpy() / ANISO_HMC
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0), ratio
    assert 0.5 < float(res.accept_rate) <= 1.0
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.var(axis=0), ANISO_HMC, rtol=0.35)


def _nuts_standard_normal():
    # tests/test_nuts_smc.py test_nuts_standard_normal
    gen = torch.Generator().manual_seed(0)
    init = torch.randn(32, 4, generator=gen, **F64)
    res = run_nuts(gen, PER_POINT["standard_normal"][0], init, 500,
                   num_warmup=300, step_size=0.2, max_depth=6, device="cpu",
                   batched_target=False)
    s = res.samples.reshape(-1, 4).numpy()
    assert float(res.divergence_rate) < 0.01
    assert 1.0 <= float(res.mean_depth) <= 6.0
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(s.var(axis=0), 1.0, atol=0.12)


def _nuts_anisotropic():
    # tests/test_nuts_smc.py test_nuts_adapts_to_anisotropy
    gen = torch.Generator().manual_seed(2)
    init = torch.randn(32, 3, generator=gen, **F64)
    res = run_nuts(gen, gauss_targets(ANISO_NUTS)[1], init, 500,
                   num_warmup=600, step_size=0.1, max_depth=8, device="cpu",
                   batched_target=False)
    s = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.var(axis=0), ANISO_NUTS, rtol=0.35)
    assert float(res.divergence_rate) < 0.01


BANDS = {"hmc_standard_normal": _hmc_standard_normal,
         "hmc_anisotropic": _hmc_anisotropic,
         "nuts_standard_normal": _nuts_standard_normal,
         "nuts_anisotropic": _nuts_anisotropic}


@pytest.mark.parametrize("case", sorted(BANDS))
def test_per_point_meets_jax_bands(case):
    """The JAX tests' runs on their per-point targets, through
    batched_target=False with the port's own generator, in JAX's bands."""
    BANDS[case]()


# ------------------------------------------------------------- pullbacks
FLOWS = ["realnvp", "spline_coupling", "spline_ar", "spline_ar_periodic"]
SIZE, SPACE, K, B, HIDDEN, AR_DIM = 4, 3, 8, 3.0, 16, 5


def flow_pair(kind, seed=3):
    """(JAX flow, its params, port flow with them, dim), two layers each
    (RealNVP with an ActNorm in front), params perturbed off the init."""
    if kind == "realnvp":
        dim = 8
        jlayers = [jb.ActNorm(dim)] + [jb.AffineCoupling(dim, HIDDEN)
                                       for _ in range(2)]
        tlayers = [tb.ActNorm(dim, **F64)] + [
            tb.AffineCoupling(dim, HIDDEN, **F64) for _ in range(2)]
        scale = 0.1
    elif kind == "spline_coupling":
        dim = SIZE * SPACE
        kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN)
        jlayers = [jb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw)
                   for a in range(2)]
        tlayers = [tb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw, **F64)
                   for a in range(2)]
        scale = 0.3
    else:
        dim = AR_DIM
        kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN,
                  periodic=kind == "spline_ar_periodic")
        jlayers = [jb.SplineAR(dim, **kw) for _ in range(2)]
        tlayers = [tb.SplineAR(dim, **kw, **F64) for _ in range(2)]
        scale = 0.3
    jflow = JFlow(jd.DiagNormal(dim), jb.Chain(jlayers))
    tflow = nft.NormalizingFlow(td.DiagNormal(dim, **F64), tb.Chain(tlayers))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return jflow, p, tflow, dim


@pytest.mark.parametrize("kind", FLOWS)
def test_pullback_logprob_matches_jax(kind):
    """pullback_logprob's value and gradient, vmapped over 24 points,
    against jax.vmap(jax.value_and_grad(pullback_logprob)) and against the
    port's batched pullback; under `frozen` no parameter gets a
    gradient."""
    jflow, p, tflow, dim = flow_pair(kind)
    z = np.random.default_rng(4).standard_normal((24, dim)) * 1.2
    jlp, jg = jax.vmap(jax.value_and_grad(
        j_pullback(jflow, p, JFunnel(dim))))(jnp.asarray(z))
    with frozen(tflow):
        lp, g = pointwise_lp_grad(pullback_logprob(tflow, NealsFunnel(dim)))(
            t(z))
        blp, bg = batched_lp_grad(pullback_logprob_batched(
            tflow, NealsFunnel(dim)))(t(z))
    close(lp, jlp, msg="value")
    close(g, jg, msg="gradient")
    close(lp, blp, **SELF, msg="value, batched")
    close(g, bg, **SELF, msg="gradient, batched")
    assert all(prm.grad is None and prm.requires_grad
               for prm in tflow.parameters())


# ---------------------------------------------------------- one transition
KERNELS = ["vmap_hmc_kernel", "hmc_kernel_batched", "hmc_kernel_chainbatched"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_transition_matches_jax(kernel):
    """One transition of 64 chains on tests/test_hmc_pallas.py's quartic
    target, on JAX's draws, against jax.vmap(hmc_kernel) (and JAX's
    chain-batched kernel), with mixed accepts; the port's per-point forms
    equal its batched transition."""
    dim, chains, step, n_leap = 5, 64, 0.45, 8
    jlogp, tpoint, tbatch = quartic_targets()
    rng = np.random.default_rng(3)
    pos = rng.standard_normal((chains, dim))
    inv_m = rng.uniform(0.6, 1.5, dim)
    key = jax.random.PRNGKey(5)
    jstate = jax.vmap(lambda q: jhmc.hmc_init(jlogp, q))(jnp.asarray(pos))
    keys = jax.random.split(key, chains)
    if kernel == "hmc_kernel_chainbatched":
        jnew, jinfo = jhmc.hmc_kernel_chainbatched(
            lambda x: -0.5 * jnp.sum(x * x, -1) - 0.1 * jnp.sum(x ** 4, -1),
            step, n_leap, jnp.asarray(inv_m))(keys, jstate)
    else:
        jnew, jinfo = jax.vmap(jhmc.hmc_kernel(
            jlogp, step, n_leap, jnp.asarray(inv_m)))(keys, jstate)
    draws = jax_draws(key, chains, dim)
    state = hmc_init(batched_lp_grad(tbatch), t(pos))
    close(state.log_prob, jstate.log_prob, msg="init lp")
    close(state.grad, jstate.grad, msg="init grad")

    if kernel == "vmap_hmc_kernel":
        new, info = torch.func.vmap(hmc_kernel(tpoint, step, n_leap,
                                               t(inv_m)))(draws, state)
    elif kernel == "hmc_kernel_batched":
        new, info = hmc_kernel_batched(tpoint, step, n_leap, t(inv_m))(
            draws, state)
    else:
        new, info = hmc_kernel_chainbatched(tbatch, step, n_leap, t(inv_m))(
            draws, state)
    accepted = np.asarray(jinfo.accepted)
    assert 0 < accepted.sum() < chains  # mixed accepts
    np.testing.assert_array_equal(info.accepted.numpy(), accepted)
    close(new.position, jnew.position, msg="position")
    close(new.log_prob, jnew.log_prob, msg="log_prob")
    close(new.grad, jnew.grad, msg="grad")
    close(info.accept_prob, jinfo.accept_prob, msg="accept_prob")
    close(info.energy_change, jinfo.energy_change, rtol=1e-9, atol=1e-11,
          msg="energy_change")

    bnew, binfo = hmc_kernel_chainbatched(tbatch, step, n_leap, t(inv_m))(
        draws, state)
    same_state(new, bnew, "batched")
    np.testing.assert_array_equal(info.accepted.numpy(),
                                  binfo.accepted.numpy())
    close(info.accept_prob, binfo.accept_prob, **SELF)


def test_hmc_kernel_rejects_divergent_proposal():
    """A NaN proposal is rejected with accept prob 0 in the per-chain
    kernel, as in JAX's (the chain keeps its state)."""
    def logprob(x):
        return torch.where(x[0] < 1.0, -0.5 * torch.sum(x * x),
                           torch.tensor(float("nan"), **F64))

    pos = torch.tensor([[0.9, 0.0], [-2.0, 0.1]], **F64)
    state = hmc_init(pointwise_lp_grad(logprob), pos)
    draws = (torch.zeros(2, 1, **F64), torch.tensor([[5.0, 0.0], [0.1, 0.0]],
                                                   **F64),
             torch.full((2,), 0.5, **F64))
    new, info = torch.func.vmap(hmc_kernel(logprob, 0.5, 3, torch.ones(
        2, **F64)))(draws, state)
    assert info.accepted.tolist() == [False, True]
    assert float(info.accept_prob[0]) == 0.0
    assert torch.equal(new.position[0], pos[0])


# ------------------------------------------------------------- whole runs
RUNS = [("gauss", 20, 130, 1), ("gauss", 0, 8, 3), ("neutra", 10, 12, 1)]


@pytest.mark.parametrize("target,num_warmup,num_samples,thin", RUNS)
def test_run_hmc_per_point_matches_jax(target, num_warmup, num_samples,
                                       thin):
    """run_hmc(batched_target=False) on JAX's draws against JAX's default
    run_hmc (per point, hmc_kernel_batched), and against the port's
    batched run on the same draws (tests/test_hmc.py:152-165's check)."""
    if target == "gauss":
        jlogp, tpoint, tbatch = gauss_targets(GAUSS)
        dim, chains, frz = len(GAUSS), 16, contextlib.nullcontext()
    else:
        jflow, p, tflow, dim = flow_pair("realnvp")
        jlogp = j_pullback(jflow, p, JFunnel(dim))
        tpoint = pullback_logprob(tflow, NealsFunnel(dim))
        tbatch = pullback_logprob_batched(tflow, NealsFunnel(dim))
        chains, frz = 16, frozen(tflow)
    init = np.random.default_rng(6).standard_normal((chains, dim))
    key = jax.random.PRNGKey(8)
    kw = dict(num_warmup=num_warmup, step_size=0.3, num_leapfrog=4,
              thin=thin)
    jres = jhmc.run_hmc(key, jlogp, jnp.asarray(init), num_samples, **kw)
    draws = hmc_run_draws(key, chains, dim, num_warmup, num_samples, thin)
    with frz:
        res = run_hmc(None, tpoint, t(init), num_samples, draws=draws,
                      device="cpu", batched_target=False, **kw)
        bres = run_hmc(None, tbatch, t(init), num_samples, draws=draws,
                       device="cpu", **kw)
    fields = ("samples", "log_probs", "accept_rate", "step_size",
              "inv_mass_diag")
    for f in fields:
        close(getattr(res, f), getattr(jres, f), **RUN, msg=f)
        close(getattr(res, f), getattr(bres, f), **SELF, msg=f"{f} batched")
    close(res.final_state.position, jres.final_state.position, **RUN)
    assert 0.3 < float(res.accept_rate) < 1.0  # mixed accepts


# ------------------------------------------------------------------- NUTS
def nuts_targets(kind):
    """(JAX per point, port per point, port batched, dim)."""
    if kind == "gauss":
        return (*gauss_targets(ANISO_NUTS * 2.0), len(ANISO_NUTS))
    jflow, p, tflow, dim = flow_pair("spline_coupling")
    return (j_pullback(jflow, p, JFunnel(dim)),
            pullback_logprob(tflow, NealsFunnel(dim)),
            pullback_logprob_batched(tflow, NealsFunnel(dim)), dim)


@pytest.mark.parametrize("kind,step,max_depth", [
    ("gauss", 0.35, 7), ("spline", 0.3, 6)])
def test_nuts_kernel_matches_jax(kind, step, max_depth):
    """nuts_kernel on JAX's draws against jax.vmap(nuts_kernel): the new
    state and every NUTSInfo field over mixed depths; and against
    nuts_transition on the batched target."""
    jlogp, tpoint, tbatch, dim = nuts_targets(kind)
    chains = 64
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((chains, dim))
    inv_m = rng.uniform(0.6, 1.5, dim)
    jstate = jax.vmap(lambda q: jhmc.hmc_init(jlogp, q))(jnp.asarray(z0))
    key = jax.random.PRNGKey(7)
    jnew, jinfo = jax.vmap(jnuts.nuts_kernel(
        jlogp, step, jnp.asarray(inv_m), max_depth))(
            jax.random.split(key, chains), jstate)
    draws = TableDraws.from_jax(key, chains, dim, max_depth)
    state = hmc_init(pointwise_lp_grad(tpoint), t(z0))
    new, info = nuts_kernel(tpoint, step, t(inv_m), max_depth)(draws, state)
    bnew, binfo = nuts_transition(batched_lp_grad(tbatch), state, draws,
                                  step, t(inv_m), max_depth)

    depths = np.asarray(jinfo.depth)
    assert len(set(depths.tolist())) >= 3, depths  # mixed depths
    for f in ("depth", "n_leapfrog", "diverged"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), f)
        assert torch.equal(getattr(info, f), getattr(binfo, f)), f
    close(new.position, jnew.position, msg="position")
    close(new.log_prob, jnew.log_prob, msg="log_prob")
    close(new.grad, jnew.grad, msg="grad")
    close(info.accept_prob, jinfo.accept_prob, msg="accept_prob")
    same_state(new, bnew, "batched")
    close(info.accept_prob, binfo.accept_prob, **SELF)


@pytest.mark.parametrize("num_warmup,num_samples", [(0, 30), (40, 10)])
def test_run_nuts_per_point_matches_jax(num_warmup, num_samples):
    """run_nuts(batched_target=False) on JAX's draws against JAX's run_nuts
    (which takes per-point targets only), and against the port's batched
    run on the same draws."""
    jlogp, tpoint, tbatch, dim = nuts_targets("gauss")
    chains, max_depth = 16, 5
    init = np.random.default_rng(6).standard_normal((chains, dim))
    key = jax.random.PRNGKey(8)
    kw = dict(num_warmup=num_warmup, step_size=0.4, max_depth=max_depth)
    jres = jnuts.run_nuts(key, jlogp, jnp.asarray(init), num_samples, **kw)
    draws = nuts_run_draws(key, chains, dim, max_depth, num_warmup,
                           num_samples)
    res = run_nuts(None, tpoint, t(init), num_samples, draws=draws,
                   device="cpu", batched_target=False, **kw)
    bres = run_nuts(None, tbatch, t(init), num_samples, draws=draws,
                    device="cpu", **kw)
    for f in ("samples", "log_probs", "accept_rate", "step_size",
              "inv_mass_diag", "mean_depth", "divergence_rate"):
        close(getattr(res, f), getattr(jres, f), msg=f)
        close(getattr(res, f), getattr(bres, f), **SELF, msg=f"{f} batched")
    close(res.final_state.position, jres.final_state.position)


# ------------------------------------------- the RQS Function's vmap rules
class Counted:
    """A plain callable that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


BOUNDS = (-2.5, 3.0, -2.0, 3.5)
FUNCTORCH = ["plain", "vmap", "vmap_in_dims_none", "nested_vmap",
             "vmap_grad", "nested_vmap_grad", "vmap_grad_in_dims_none"]


def rqs_inputs(seed, b1=3, b2=4, n=6, k=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.5, 4.0, (b1, b2, n))
    x[0, 0, :2] = (BOUNDS[0], BOUNDS[1])  # on the bounds
    return (t(x), t(rng.standard_normal((b1, b2, n, k))),
            t(rng.standard_normal((b1, b2, n, k))),
            t(rng.standard_normal((b1, b2, n, k - 1))))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", FUNCTORCH)
def test_fused_rqs_under_torch_func(case, inverse):
    """_FusedRQS and _RQSVJP with the plain versions injected: under vmap,
    nested vmap and vmap(grad), with w, h, d batched or not, each equals
    the batched call (its values; its gradient by autograd), and the
    injected forward and VJP run once an evaluation, whatever the batch."""
    x, w, h, d = rqs_inputs(7)
    fwd, vjp = Counted(ops_rqs.plain_rqs), Counted(ops_rqs.rqs_vjp_plain)

    def rqs(x, w, h, d):
        return ops_rqs.unconstrained_rqs_fused(
            x, w, h, d, inverse, *BOUNDS, forward=fwd, backward=vjp)

    def loss(x, w, h, d):
        y, ld = rqs(x, w, h, d)
        return torch.sum(y * y) + torch.sum(torch.sin(ld))

    if case.endswith("in_dims_none"):
        # one spline for every row of the batch
        x2 = x.reshape(-1, x.shape[-1])
        w, h, d = w[0, 0], h[0, 0], d[0, 0]
        dims = (0, None, None, None)
        full = (x2,) + tuple(a.expand(x2.shape[0], *a.shape)
                             for a in (w, h, d))
    else:
        dims = (0, 0, 0, 0)
        full = (x, w, h, d)
    func = torch.func
    if case == "plain":
        xs = [a.clone().requires_grad_(True) for a in full]
        got = rqs(*xs)
        got_g = torch.autograd.grad(
            torch.sum(got[0] ** 2) + torch.sum(torch.sin(got[1])), xs[0])[0]
    elif case == "vmap":
        got = func.vmap(rqs)(x, w, h, d)
    elif case == "vmap_in_dims_none":
        got = func.vmap(rqs, in_dims=dims)(x2, w, h, d)
    elif case == "nested_vmap":
        got = func.vmap(func.vmap(rqs))(x, w, h, d)
    elif case == "vmap_grad":
        got_g = func.vmap(func.grad(loss))(x, w, h, d)
    elif case == "nested_vmap_grad":
        got_g = func.vmap(func.vmap(func.grad(loss)))(x, w, h, d)
    else:
        got_g = func.vmap(func.grad(loss), in_dims=dims)(x2, w, h, d)
    grad_case = "grad" in case
    assert fwd.calls == 1
    assert vjp.calls == (1 if grad_case or case == "plain" else 0)

    ref = [a.clone().requires_grad_(True) for a in full]
    want = ops_rqs.plain_rqs(*ref, inverse, *BOUNDS)
    if grad_case or case == "plain":
        want_g = torch.autograd.grad(
            torch.sum(want[0] ** 2) + torch.sum(torch.sin(want[1])), ref[0])[0]
        close(got_g, want_g.reshape(got_g.shape), **SELF, msg="gradient")
    if not grad_case:
        for a, b, name in zip(got, want, ("y", "log-det")):
            close(a, b.reshape(a.shape), **SELF, msg=name)


# -------------------------------------------------------------------- MLP
@pytest.mark.parametrize("zero_last", [False, True])
def test_mlp_matches_jax(zero_last):
    """mlp_init's leaves (names, shapes, bounds, the zeroed last layer),
    mlp_apply on JAX's leaves against JAX's mlp_apply, and MLP built on
    mlp_init (the same draws from the same generator) as the same map."""
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), 6, 5, 16, jnp.float64,
                       zero_last=zero_last)
    tp = mlp_init(6, 5, 16, zero_last=zero_last,
                  generator=torch.Generator().manual_seed(0), **F64)
    assert list(tp) == list(jp) == ["w1", "b1", "w2", "b2", "w3", "b3"]
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert tp[name].dtype == torch.float64
    assert float(tp["w1"].abs().max()) <= 1 / np.sqrt(6)
    assert float(tp["w2"].abs().max()) <= 1 / np.sqrt(16)
    assert (not zero_last) == bool(tp["w3"].abs().max() > 0)
    jp = perturbed_leaves(jp)
    x = np.random.default_rng(1).standard_normal((7, 6))
    close(mlp_apply({k: t(v) for k, v in jp.items()}, t(x)),
          jmlp.mlp_apply(jp, jnp.asarray(x)), **SELF)

    mod = MLP(6, 5, 16, zero_last=zero_last,
              generator=torch.Generator().manual_seed(0), **F64)
    for name, leaf in tp.items():
        assert torch.equal(getattr(mod, name).detach(), leaf), name
    with torch.no_grad():
        close(mod(t(x)), mlp_apply(tp, t(x)), rtol=0, atol=0)


def perturbed_leaves(leaves):
    rng = np.random.default_rng(2)
    return {k: jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(
        v.shape)) for k, v in leaves.items()}
