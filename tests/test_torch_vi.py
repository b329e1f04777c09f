"""Variational inference on the port against the JAX package: BASELINE
configs 2 and 3 as tests/test_vi.py defines them, in float64 on the CPU.

The four flows of tests/test_vi.py, each on the target its JAX test pairs
it with: 8 x Invert(Planar(2)) on CorrelatedGaussian(2, rho 0.7), 6 x
Radial(2) on the one-centre GaussianMixture, ActNorm(3) on
CorrelatedGaussian(3, rho 0.5), and 2 x SplineCoupling(size 4, space_dim
2, K 8, B 4, hidden 32) + InvertibleLinear(8) on CorrelatedGaussian(8, rho
0.6), trained by forward KL.

  (a) ELBO, reverse KL and forward KL, value and the gradient of every
      parameter, against JAX's at rtol 1e-10 (a gradient's absolute floor is
      1e-10 of its leaf's largest entry), on JAX's perturbed params through
      `params.from_jax` and JAX's own prior draws (injected as `z=`), or its
      target draws for forward KL; elbo == -reverse_kl on the same latents.
  (b) 20 Adam steps of each fit from JAX's init, step for step: every
      step's loss and the final params within rtol 1e-8. Rounding grows
      under training (1e-14 to 1e-2 over 300 steps at 3e-3), so the fits
      stop at 20 steps, where the gap stays inside 1e-8.
  (c) tests/test_vi.py's five cases run on the port, with the port's own
      init and a torch generator, in JAX's bands. torch cannot replay
      threefry, so these hold in law.

JAX keeps GaussianMixture's centres and vars in float32 under x64, so its
log-density carries a float32 normalising constant; the Radial case
compares each side's loss measured from its own target's log-density at
the centre, where that constant cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.targets import CorrelatedGaussian as JCorrelated
from normalizingflow_tpu.train.objectives import elbo as j_elbo
from normalizingflow_tpu.train.objectives import (
    forward_kl_loss as j_forward_kl_loss,
)
from normalizingflow_tpu.train.objectives import reverse_kl as j_reverse_kl

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.targets import CorrelatedGaussian
from normalizingflow_tpu_torch.train.loop import Adam
from normalizingflow_tpu_torch.train.objectives import (
    elbo,
    forward_kl_loss,
    reverse_kl,
)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
NSAMPLES = 256          # draws a step, as tests/test_vi.py
FIT_STEPS = 20          # (b): where the training dynamics do not amplify
FIT_RTOL = 1e-8
GM_CENTER, GM_VAR = [[1.0, 1.0]], [0.5]


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def spline_layers(lib, size, dim, **kw):
    return [lib.SplineCoupling(size=size, space_dim=2, num_bins=8,
                               tail_bound=4.0, hidden_dim=32, mask=(a,), **kw)
            for a in range(2)] + [lib.InvertibleLinear(dim, **kw)]


def vi_case(kind):
    """(JAX flow, port flow, JAX target, port target, objective, lr): the
    flow and target of tests/test_vi.py's case, the objective "rkl" (ELBO
    fits) or "fkl" (forward KL on target draws), and the case's rate."""
    if kind == "planar":
        dim, n = 2, 8
        jbij = jb.Chain([jb.Invert(jb.Planar(dim)) for _ in range(n)])
        tbij = tb.Chain([tb.Invert(tb.Planar(dim, **F64)) for _ in range(n)])
        targets = JCorrelated(dim, rho=0.7), CorrelatedGaussian(dim, 0.7,
                                                                **F64)
        objective, lr = "rkl", 5e-3
    elif kind == "radial":
        dim, n = 2, 6
        jbij = jb.Chain([jb.Radial(dim) for _ in range(n)])
        tbij = tb.Chain([tb.Radial(dim, **F64) for _ in range(n)])
        jgm = jd.GaussianMixture(GM_CENTER, GM_VAR, npoints=1, point_dim=2)
        # JAX's float32 centres and vars, as the port is handed them
        targets = jgm, td.GaussianMixture(
            np.asarray(jgm.centers, np.float64), np.asarray(jgm.vars,
                                                            np.float64),
            npoints=1, point_dim=2, **F64)
        objective, lr = "rkl", 5e-3
    elif kind == "actnorm":
        dim = 3
        jbij, tbij = jb.Chain([jb.ActNorm(dim)]), tb.Chain(
            [tb.ActNorm(dim, **F64)])
        targets = JCorrelated(dim, rho=0.5), CorrelatedGaussian(dim, 0.5,
                                                                **F64)
        objective, lr = "rkl", 5e-3
    elif kind == "spline":
        dim = 8
        jbij = jb.Chain(spline_layers(jb, 4, dim))
        tbij = tb.Chain(spline_layers(tb, 4, dim, **F64))
        targets = JCorrelated(dim, rho=0.6), CorrelatedGaussian(dim, 0.6,
                                                                **F64)
        objective, lr = "fkl", 3e-3
    else:
        raise ValueError(kind)
    jflow = JFlow(jd.DiagNormal(dim), jbij)
    tflow = nft.NormalizingFlow(td.DiagNormal(dim, **F64), tbij)
    return jflow, tflow, *targets, objective, lr


def jax_init(jflow, seed):
    """JAX's init in float64 (its MLPs initialise in float32)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                        jflow.init(jax.random.PRNGKey(seed)))


def perturbed(jflow, seed, scale=0.1):
    """JAX's init, each leaf moved by scale * N(0, 1) (InvertibleLinear's
    permutation P kept), so that no layer is the identity."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if path[-1].key == "P":
            return a
        return a + scale * rng.standard_normal(np.shape(a))

    return jax.tree_util.tree_map_with_path(move, jax_init(jflow, seed))


def gm_offset(target, lib):
    """The target's log-density at its centre: subtracting it from the
    loss cancels the normalising constant (float32 in JAX)."""
    c = np.asarray(GM_CENTER, np.float64).reshape(1, -1)
    if lib is torch:
        return float(target.log_prob(t(c))[0])
    return float(target.log_prob(jnp.asarray(c))[0])


def compare_grads(tflow, jgrad):
    """Every parameter's gradient against JAX's leaf (zero where the port
    takes none: InvertibleLinear's P, stop_gradient in JAX)."""
    leaves = tparams.jax_leaves(tflow, jgrad)
    params = list(tflow.parameters())
    assert len(leaves) == len(params)
    for i, (p, g) in enumerate(zip(params, leaves)):
        g = np.asarray(g)
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(
            got, g, rtol=1e-10, atol=1e-10 * max(np.abs(g).max(), 1e-300),
            err_msg=f"gradient of parameter {i}")


def jax_draws(jflow, jtarget, objective, key, n=NSAMPLES):
    """The batch JAX's objective uses with `key`: its prior draws (reverse
    KL) or target draws (forward KL)."""
    if objective == "rkl":
        return np.asarray(jflow.prior.sample(key, n))
    return np.asarray(jtarget.sample(key, n))


def jax_loss(jflow, jtarget, objective, key, n=NSAMPLES):
    if objective == "rkl":
        return lambda q: j_reverse_kl(jflow, q, jtarget, key, n)
    return lambda q: j_forward_kl_loss(jflow, q, jtarget.sample(key, n))[0]


def port_loss(tflow, ttarget, objective, draws):
    if objective == "rkl":
        return reverse_kl(tflow, ttarget, z=t(draws))
    return forward_kl_loss(tflow, t(draws))[0]


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("kind", ["planar", "radial", "actnorm", "spline"])
def test_objective_and_grads_match_jax(kind):
    """The case's objective and its gradient on JAX's params and draws;
    for the ELBO flows elbo and reverse_kl both."""
    jflow, tflow, jtarget, ttarget, objective, _ = vi_case(kind)
    p = perturbed(jflow, 3)
    tparams.from_jax(tflow, p)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(jflow, jtarget, objective, key)
    fns = [(jax_loss(jflow, jtarget, objective, key),
            lambda: port_loss(tflow, ttarget, objective, draws))]
    if objective == "rkl":
        fns.append((lambda q: j_elbo(jflow, q, jtarget, key, NSAMPLES),
                    lambda: elbo(tflow, ttarget, z=t(draws))))
    for sign, (jfn, tfn) in zip((1.0, -1.0), fns):
        jval, jgrad = jax.jit(jax.value_and_grad(jfn))(p)
        tflow.zero_grad(set_to_none=True)
        tval = tfn()
        tval.backward()
        want, got = float(jval), float(tval.detach())
        if kind == "radial":
            want += sign * gm_offset(jtarget, jnp)
            got += sign * gm_offset(ttarget, torch)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        compare_grads(tflow, jgrad)


@pytest.mark.parametrize("kind", ["planar", "radial", "actnorm"])
def test_elbo_is_minus_reverse_kl_on_the_same_latents(kind):
    _, tflow, _, ttarget, _, _ = vi_case(kind)
    z = td.DiagNormal(tflow.prior.dim, **F64).sample(
        512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        e = elbo(tflow, ttarget, z=z)
        r = reverse_kl(tflow, ttarget, z=z)
    assert torch.isfinite(e) and float(e) == -float(r)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("kind", ["planar", "radial", "spline"])
def test_short_fit_matches_jax_step_for_step(kind):
    """tests/test_vi.py's fit loop (optax.adam at the case's constant rate,
    step keys PRNGKey(1000 + i)) for FIT_STEPS steps from JAX's init,
    against the port's Adam and objective on the same draws."""
    jflow, tflow, jtarget, ttarget, objective, lr = vi_case(kind)
    p = jax_init(jflow, 0)
    tparams.from_jax(tflow, p)
    optimizer = optax.adam(lr)
    state = optimizer.init(p)
    topt = Adam(list(tflow.parameters()), lambda count: lr)

    @jax.jit
    def jstep(p, state, key):
        loss, g = jax.value_and_grad(jax_loss(jflow, jtarget, objective,
                                              key))(p)
        upd, state = optimizer.update(g, state, p)
        return optax.apply_updates(p, upd), state, loss

    for i in range(FIT_STEPS):
        key = jax.random.PRNGKey(1000 + i)
        draws = jax_draws(jflow, jtarget, objective, key)
        p, state, jval = jstep(p, state, key)
        topt.zero_grad(set_to_none=True)
        tval = port_loss(tflow, ttarget, objective, draws)
        tval.backward()
        topt.step()
        want, got = float(jval), float(tval.detach())
        if kind == "radial":
            want += gm_offset(jtarget, jnp)
            got += gm_offset(ttarget, torch)
        np.testing.assert_allclose(got, want, rtol=FIT_RTOL,
                                   err_msg=f"loss of step {i}")
    start = jax.tree.leaves(jax_init(jflow, 0))
    moved = False
    for a, b, a0 in zip(jax.tree.leaves(tparams.to_numpy(tflow)),
                        jax.tree.leaves(p), start):
        np.testing.assert_allclose(a, np.asarray(b), rtol=FIT_RTOL,
                                   atol=1e-12)
        moved |= not np.allclose(a, np.asarray(a0), rtol=0, atol=1e-3)
    assert moved


# ------------------------------------------------------------------ (c)
def port_fit(tflow, ttarget, steps, lr, seed, objective="rkl"):
    """tests/test_vi.py's fit loop on the port: Adam at a constant rate,
    NSAMPLES fresh draws a step from a torch generator. Returns the
    losses."""
    gen = torch.Generator().manual_seed(seed)
    opt = Adam(list(tflow.parameters()), lambda count: lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        if objective == "rkl":
            loss = reverse_kl(tflow, ttarget, NSAMPLES, generator=gen)
        else:
            loss = forward_kl_loss(tflow, ttarget.sample(
                NSAMPLES, generator=gen))[0]
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def port_flow(bijectors, dim):
    return nft.NormalizingFlow(td.DiagNormal(dim, **F64),
                               tb.Chain(bijectors))


def test_planar_stack_vi():
    """tests/test_vi.py test_planar_stack_vi: 800 ELBO steps; the loss
    drops by 0.2 and the covariance of 8000 draws is within 0.25."""
    gen = torch.Generator().manual_seed(0)
    target = CorrelatedGaussian(2, rho=0.7, **F64)
    flow = port_flow([tb.Invert(tb.Planar(2, generator=gen, **F64))
                      for _ in range(8)], 2)
    losses = port_fit(flow, target, 800, 5e-3, seed=1)
    assert losses[-1] < losses[0] - 0.2
    with torch.no_grad():
        x, _, _ = flow.sample(8000, generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(np.cov(x.numpy().T), target.cov.numpy(),
                               atol=0.25)


def test_radial_stack_vi():
    """tests/test_vi.py test_radial_stack_vi: 600 ELBO steps; the mean of
    8000 draws within 0.2 of the centre (1, 1)."""
    gen = torch.Generator().manual_seed(0)
    target = td.GaussianMixture(GM_CENTER, GM_VAR, npoints=1, point_dim=2,
                                **F64)
    flow = port_flow([tb.Radial(2, generator=gen, **F64) for _ in range(6)],
                     2)
    port_fit(flow, target, 600, 5e-3, seed=1)
    with torch.no_grad():
        x, _, _ = flow.sample(8000, generator=torch.Generator().manual_seed(8))
    np.testing.assert_allclose(x.numpy().mean(axis=0), 1.0, atol=0.2)


def test_elbo_is_negative_reverse_kl():
    """tests/test_vi.py test_elbo_is_negative_reverse_kl: on one generator
    state, ELBO and reverse KL at 512 draws agree at rtol 1e-6."""
    flow = port_flow([tb.ActNorm(2, **F64)], 2)
    target = CorrelatedGaussian(2, **F64)
    with torch.no_grad():
        e = float(elbo(flow, target, 512,
                       generator=torch.Generator().manual_seed(1)))
        r = float(reverse_kl(flow, target, 512,
                             generator=torch.Generator().manual_seed(1)))
    np.testing.assert_allclose(e, -r, rtol=1e-6)


def test_elbo_bounds_log_evidence():
    """tests/test_vi.py test_elbo_bounds_log_evidence: for a normalised
    target the ELBO at 20000 draws is at most 0 up to Monte-Carlo error."""
    flow = port_flow([tb.ActNorm(3, **F64)], 3)
    target = CorrelatedGaussian(3, rho=0.5, **F64)
    with torch.no_grad():
        e = float(elbo(flow, target, 20000,
                       generator=torch.Generator().manual_seed(3)))
    assert e < 0.05


def test_spline_flow_on_correlated_gaussian():
    """tests/test_vi.py test_spline_flow_on_correlated_gaussian (BASELINE
    config 3): 500 forward-KL steps at 3e-3, then 4000 draws round-trip
    within 1e-3 and their covariance has max |diag - 1| < 0.3 and mean
    |off-diagonal - target| < 0.2."""
    dim = 8
    gen = torch.Generator().manual_seed(0)
    target = CorrelatedGaussian(dim, rho=0.6, **F64)
    flow = port_flow(spline_layers(tb, 4, dim, generator=gen, **F64), dim)
    port_fit(flow, target, 500, 3e-3, seed=1, objective="fkl")
    with torch.no_grad():
        x, _, z = flow.sample(4000, generator=torch.Generator().manual_seed(9))
        z2, _, _ = flow.forward(x)
    np.testing.assert_allclose(z2.numpy(), z.numpy(), atol=1e-3)
    cov = np.cov(x.numpy().T)
    assert np.abs(np.diag(cov) - 1.0).max() < 0.3
    iu = np.triu_indices(dim, 1)
    assert np.abs(cov[iu] - target.cov.numpy()[iu]).mean() < 0.2


def test_vi_stats_reads_the_moments_it_names():
    """tools/vi_moments.py's statistics, which gate the card's 32-d fits
    and make JAX's bands: draws whitened to BASELINE's covariance read 0;
    scaled by 1.1 they read var_rel 0.21 and no correlation error; shifted
    by 0.05 standard deviations they read mean_sd 0.05."""
    from tools.vi_moments import vi_stats

    cov = JCorrelated().cov.astype(np.float64)   # (32, rho 0.9)
    z = np.random.default_rng(0).standard_normal((4000, 32))
    z -= z.mean(0)
    z = np.linalg.solve(np.linalg.cholesky(np.cov(z.T)), z.T).T
    x = z @ np.linalg.cholesky(cov).T
    exact = vi_stats(x, cov)
    assert max(exact.values()) < 1e-12
    scaled = vi_stats(1.1 * x, cov)
    np.testing.assert_allclose(scaled["var_rel"], 0.21, rtol=1e-12)
    assert scaled["corr_err"] < 1e-12
    shifted = vi_stats(x + 0.05 * np.sqrt(np.diag(cov)), cov)
    np.testing.assert_allclose(shifted["mean_sd"], 0.05, rtol=1e-12)


def test_banana_cov_is_the_law_of_banana_draws():
    """tools/vi_moments.py's closed-form covariance of Banana(32, b 0.1,
    s0 3), which the card's banana32 gates read, against the sample
    covariance of 200000 of the port's Banana draws: diag(9, 2.62, 1,
    ...) within 0.06 (about 3 standard errors of x1's variance)."""
    from normalizingflow_tpu_torch.targets import Banana
    from tools.vi_moments import banana_cov

    x = Banana(32, b=0.1, s0=3.0).sample(
        200000, generator=torch.Generator().manual_seed(0), **F64)
    np.testing.assert_allclose(np.cov(x.numpy().T),
                               banana_cov(32, 0.1, 3.0), atol=0.06)
