"""Parity of the port's flow layers with the JAX package, in float64.

Params come from the JAX `init`, are perturbed (so zero-initialised layers
are not the identity) and go through `params.from_jax`; inputs come from
numpy. Both packages then compute the same functions; tolerance rtol 1e-10
(the two differ only in the order of floating-point sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.targets import NealsFunnel as JFunnel
from normalizingflow_tpu.train.objectives import reverse_kl as j_reverse_kl

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.train.objectives import reverse_kl

torch.set_num_threads(1)

DIM, HIDDEN, BATCH = 8, 16, 32
RTOL, ATOL = 1e-10, 1e-12
F64 = dict(dtype=torch.float64, device="cpu")


def perturbed_params(bij, seed, scale=0.1):
    """JAX init params in float64, each leaf moved by scale * N(0, 1)."""
    rng = np.random.default_rng(seed)
    tree = bij.init(jax.random.PRNGKey(seed))
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + scale * rng.standard_normal(np.shape(a)), tree)


def layer_pair(kind):
    if kind == "actnorm":
        return jb.ActNorm(DIM), tb.ActNorm(DIM, **F64)
    if kind == "affine":
        return (jb.AffineCoupling(DIM, HIDDEN),
                tb.AffineCoupling(DIM, HIDDEN, **F64))
    if kind == "affine_s_cap":
        return (jb.AffineCoupling(DIM, HIDDEN, s_cap=2.0),
                tb.AffineCoupling(DIM, HIDDEN, s_cap=2.0, **F64))
    if kind == "affine_zero_init":
        return (jb.AffineCoupling(DIM, HIDDEN, zero_init=True),
                tb.AffineCoupling(DIM, HIDDEN, zero_init=True, **F64))
    if kind == "chain":
        return (jb.Chain([jb.ActNorm(DIM), jb.AffineCoupling(DIM, HIDDEN),
                          jb.AffineCoupling(DIM, HIDDEN, s_cap=2.0)]),
                tb.Chain([tb.ActNorm(DIM, **F64),
                          tb.AffineCoupling(DIM, HIDDEN, **F64),
                          tb.AffineCoupling(DIM, HIDDEN, s_cap=2.0, **F64)]))
    if kind == "invert":
        return (jb.Invert(jb.AffineCoupling(DIM, HIDDEN)),
                tb.Invert(tb.AffineCoupling(DIM, HIDDEN, **F64)))
    raise ValueError(kind)


def build_flows(layers=2):
    """The bench's RealNVP stack (ActNorm + AffineCoupling x layers) in
    both packages, with shared perturbed params."""
    jflow = JFlow(jd.DiagNormal(DIM), jb.Chain(
        [jb.ActNorm(DIM)] + [jb.AffineCoupling(DIM, HIDDEN)
                             for _ in range(layers)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Chain(
        [tb.ActNorm(DIM, **F64)] + [tb.AffineCoupling(DIM, HIDDEN, **F64)
                                    for _ in range(layers)]))
    jparams = perturbed_params(jflow, 3)
    tparams.from_jax(tflow, jparams)
    return jflow, jparams, tflow


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["actnorm", "affine", "affine_s_cap",
                                  "affine_zero_init", "chain", "invert"])
def test_bijector_matches_jax(kind):
    jbij, tbij = layer_pair(kind)
    p = perturbed_params(jbij, 1)
    tparams.from_jax(tbij, p)
    x = np.random.default_rng(0).standard_normal((BATCH, DIM)) * 1.5
    jy, jld = jbij.forward(p, jnp.asarray(x))
    ty, tld = tbij.forward(t(x))
    close(ty, jy)
    close(tld, jld)
    jx, jild = jbij.inverse(p, jy)
    tx, tild = tbij.inverse(ty)
    close(tx, jx)
    close(tild, jild)
    close(tx, x, rtol=1e-9, atol=1e-9)  # round trip


def jacobian_log_det(bij, x):
    """log|det| of each row's Jacobian of bij.forward, by autograd."""
    def single(xi):
        return bij.forward(xi[None])[0][0]

    return torch.stack([torch.linalg.slogdet(
        torch.autograd.functional.jacobian(single, xi))[1] for xi in x])


def test_chain_roundtrip_heterogeneous():
    """tests/test_bijectors.py's heterogeneous Chain (ActNorm,
    AffineCoupling, InvertibleLinear, SplineAR) on JAX's init: forward and
    log-det equal JAX's, the round trip holds at 1e-8 and the log-det is
    log|det| of the Jacobian."""
    kw = dict(num_bins=4, tail_bound=4.0, hidden_dim=8)
    jbij = jb.Chain([jb.ActNorm(DIM), jb.AffineCoupling(DIM, 8),
                     jb.InvertibleLinear(DIM), jb.SplineAR(DIM, **kw)])
    tbij = tb.Chain([tb.ActNorm(DIM, **F64), tb.AffineCoupling(DIM, 8, **F64),
                     tb.InvertibleLinear(DIM, **F64),
                     tb.SplineAR(DIM, **kw, **F64)])
    p = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     jbij.init(jax.random.PRNGKey(13)))
    tparams.from_jax(tbij, p)
    x = np.random.default_rng(13).standard_normal((BATCH, DIM))
    jy, jld = jbij.forward(p, jnp.asarray(x))
    with torch.no_grad():
        ty, tld = tbij.forward(t(x))
        tx, tild = tbij.inverse(ty)
    close(ty, jy)
    close(tld, jld)
    close(tx, x, rtol=0, atol=1e-8)
    close(tld + tild, np.zeros(BATCH), rtol=0, atol=1e-8)
    close(jacobian_log_det(tbij, t(x[:8])), np.asarray(tld[:8]), rtol=0,
          atol=1e-8)


def test_repeat_equals_its_chain():
    """A Repeat of 3 AffineCouplings on JAX's stacked params equals JAX's
    Repeat, and the Chain of the same layers with each layer's slice of the
    params; the inverse round-trips."""
    jrep = jb.Repeat(jb.AffineCoupling(DIM, hidden_dim=8), 3)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     jrep.init(jax.random.PRNGKey(11)))
    trep = tb.Repeat([tb.AffineCoupling(DIM, 8, **F64) for _ in range(3)])
    chain = tb.Chain([tb.AffineCoupling(DIM, 8, **F64) for _ in range(3)])
    tparams.from_jax(trep, p)
    tparams.from_jax(chain, tuple(jax.tree.map(lambda a, i=i: a[i], p)
                                  for i in range(3)))
    x = np.random.default_rng(12).standard_normal((BATCH, DIM))
    jy, jld = jrep.forward(p, jnp.asarray(x))
    with torch.no_grad():
        ty, tld = trep.forward(t(x))
        cy, cld = chain.forward(t(x))
        tx, tild = trep.inverse(ty)
    close(ty, jy)
    close(tld, jld)
    assert torch.equal(ty, cy) and torch.equal(tld, cld)
    close(tx, x, rtol=0, atol=1e-9)
    close(tld + tild, np.zeros(BATCH), rtol=0, atol=1e-9)


def test_deep_wide_realnvp_stack_finite_with_s_cap():
    """tests/test_bijectors.py's 10-layer clamped stack (dim 32, hidden 64,
    s_cap 2) on JAX's init keeps 3-sigma data finite, |log-det| within
    10 * 2 * dim, and equals JAX's forward."""
    dim, n = 32, 10
    jbij = jb.Chain([jb.AffineCoupling(dim, hidden_dim=64, s_cap=2.0)
                     for _ in range(n)])
    tbij = tb.Chain([tb.AffineCoupling(dim, 64, s_cap=2.0, **F64)
                     for _ in range(n)])
    p = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     jbij.init(jax.random.PRNGKey(13)))
    tparams.from_jax(tbij, p)
    x = 3.0 * np.random.default_rng(14).standard_normal((16, dim))
    with torch.no_grad():
        z, ld = tbij.forward(t(x))
    assert bool(torch.isfinite(z).all())
    assert bool((ld.abs() <= n * 2.0 * dim).all())
    jz, jld = jbij.forward(p, jnp.asarray(x))
    close(z, jz)
    close(ld, jld)


def test_zero_init_is_identity():
    layer = tb.AffineCoupling(DIM, HIDDEN, zero_init=True, **F64)
    for name in ("t1", "s1", "t2", "s2"):
        mlp = getattr(layer, name)
        assert not mlp.w3.any() and not mlp.b3.any()
        assert mlp.w1.abs().max() > 0
    x = t(np.random.default_rng(1).standard_normal((BATCH, DIM)))
    y, ld = layer.forward(x)
    assert torch.equal(y, x) and not ld.any()


def test_mlp_init_is_torch_default_uniform():
    gen = torch.Generator().manual_seed(0)
    mlp = tb.MLP(6, 5, 40, generator=gen, **F64)
    for w, fan_in in ((mlp.w1, 6), (mlp.w2, 40), (mlp.w3, 40)):
        bound = 1.0 / np.sqrt(fan_in)
        assert w.abs().max() <= bound
        assert w.abs().max() > 0.8 * bound  # fills the interval
    again = tb.MLP(6, 5, 40, generator=torch.Generator().manual_seed(0),
                   **F64)
    assert all(torch.equal(a, b) for a, b in
               zip(mlp.parameters(), again.parameters()))
    assert tuple(mlp.w1.shape) == (6, 40)  # JAX (fan_in, fan_out) layout


def test_flow_matches_jax():
    jflow, p, tflow = build_flows()
    x = np.random.default_rng(2).standard_normal((BATCH, DIM)) * 2.0
    jz, jprior, jld = jflow.forward(p, jnp.asarray(x))
    tz, tprior, tld = tflow.forward(t(x))
    close(tz, jz)
    close(tprior, jprior)
    close(tld, jld)
    close(tflow.log_prob(t(x)), jflow.log_prob(p, jnp.asarray(x)))
    close(tflow.evaluate(t(x)), jflow.evaluate(p, jnp.asarray(x)))
    jx, jild = jflow.inverse(p, jz)
    tx, tild = tflow.inverse(tz)
    close(tx, jx)
    close(tild, jild)

    key = jax.random.PRNGKey(4)
    jxs, jlogpx, jzs = jflow.sample(p, key, BATCH)
    txs, tlogpx, tzs = tflow.sample(z=t(jzs))
    close(txs, jxs)
    close(tlogpx, jlogpx)
    assert torch.equal(tzs, t(jzs))


def test_prior_matches_jax():
    z = np.random.default_rng(5).standard_normal((BATCH, DIM))
    close(td.DiagNormal(DIM, mean=0.5, var=2.0, **F64).log_prob(t(z)),
          jd.DiagNormal(DIM, mean=0.5, var=2.0).log_prob(jnp.asarray(z)))
    draws = td.DiagNormal(DIM, **F64).sample(
        20000, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (20000, DIM) and draws.dtype == torch.float64
    assert abs(float(draws.mean())) < 0.01
    assert abs(float(draws.var()) - 1.0) < 0.02


def test_reverse_kl_and_grads_match_jax():
    """Loss and its gradient with respect to every parameter, on the same
    prior draws, against jax.value_and_grad of the JAX reverse_kl."""
    jflow, p, tflow = build_flows()
    jtarget, ttarget = JFunnel(DIM), NealsFunnel(DIM)
    key = jax.random.PRNGKey(6)
    z = jflow.prior.sample(key, BATCH)
    jloss, jgrad = jax.value_and_grad(
        lambda q: j_reverse_kl(jflow, q, jtarget, key, BATCH))(p)
    tloss = reverse_kl(tflow, ttarget, z=t(z))
    tloss.backward()
    close(tloss, jloss)
    tgrad = jax.tree.map(np.asarray, tparams.to_numpy(tflow))
    grads = {name: prm.grad.numpy() for name, prm in tflow.named_parameters()}
    flat_j = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert len(flat_j) == len(grads) == len(jax.tree.leaves(tgrad))
    for path, g in flat_j:
        i = path[0].idx
        rest = [k.key for k in path[1:]]
        name = ".".join(["bijector.bijectors", str(i)] + rest)
        np.testing.assert_allclose(grads[name], np.asarray(g), rtol=1e-9,
                                   atol=1e-11, err_msg=name)


def test_params_bridge_round_trip():
    jflow, p, tflow = build_flows()
    back = tparams.to_numpy(tflow)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    # the JAX init itself (float32 MLPs, default-dtype ActNorm) loads too
    fresh = jflow.init(jax.random.PRNGKey(0))
    tparams.from_jax(tflow, fresh)
    for a, b in zip(jax.tree.leaves(tparams.to_numpy(tflow)),
                    jax.tree.leaves(fresh)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float64))


def test_params_bridge_rejects_mismatch():
    jflow, p, tflow = build_flows()
    with pytest.raises(ValueError, match="sequence"):
        tparams.from_jax(tflow, p[:2])
    bad_shape = (p[0], dict(p[1], t1=dict(p[1]["t1"], w1=np.zeros((3, 3)))),
                 p[2])
    with pytest.raises(ValueError, match="shape"):
        tparams.from_jax(tflow, bad_shape)
    bad_key = ({"mu": p[0]["mu"]}, p[1], p[2])
    with pytest.raises(ValueError, match="keys"):
        tparams.from_jax(tflow, bad_key)


def target_pair(kind, dim=6):
    from normalizingflow_tpu import targets as jt
    from normalizingflow_tpu_torch import targets as tt

    if kind == "funnel":
        return jt.NealsFunnel(dim), tt.NealsFunnel(dim)
    if kind == "ill_conditioned":
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3), dim))
        return (jt.IllConditionedGaussian(dim, condition=50.0, seed=3),
                tt.IllConditionedGaussian(dim, perm, condition=50.0, **F64))
    if kind == "banana":
        return jt.Banana(dim, b=0.2, s0=2.0), tt.Banana(dim, b=0.2, s0=2.0)
    if kind == "correlated":
        return (jt.CorrelatedGaussian(dim, rho=0.7),
                tt.CorrelatedGaussian(dim, rho=0.7, **F64))
    if kind == "potential":
        return (jt.PotentialTarget(lambda x: jnp.sum(x**4) - jnp.sum(x),
                                   dim, beta=0.7),
                tt.PotentialTarget(lambda x: torch.sum(x**4, -1)
                                   - torch.sum(x, -1), dim, beta=0.7))
    raise ValueError(kind)


TARGETS = ["funnel", "ill_conditioned", "banana", "correlated", "potential"]


@pytest.mark.parametrize("kind", TARGETS)
def test_target_log_prob_and_force_match_jax(kind):
    jtarget, ttarget = target_pair(kind)
    x = np.random.default_rng(8).standard_normal((BATCH, 6)) * 0.8
    close(ttarget.log_prob(t(x)), jtarget.log_prob(jnp.asarray(x)))
    close(ttarget.potential(t(x)), jtarget.potential(jnp.asarray(x)))
    close(ttarget.force(t(x)), jtarget.force(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["funnel", "ill_conditioned", "banana",
                                  "correlated"])
def test_target_samples_have_the_target_moments(kind):
    """torch draws from `generator` follow the same law as JAX's: compare
    the first two moments of 40000 draws of each (float64)."""
    jtarget, ttarget = target_pair(kind)
    n = 40000
    gen = torch.Generator().manual_seed(0)
    if kind in ("funnel", "banana"):
        xs = ttarget.sample(n, generator=gen, dtype=torch.float64)
    else:
        xs = ttarget.sample(n, generator=gen)
    ref = np.asarray(jtarget.sample(jax.random.PRNGKey(0), n))
    xs = xs.numpy()
    assert xs.shape == ref.shape == (n, 6) and xs.dtype == np.float64
    # rest of the funnel is heavy-tailed: compare v and log|x_i| instead
    if kind == "funnel":
        xs = np.concatenate([xs[:, :1], np.log(np.abs(xs[:, 1:]))], 1)
        ref = np.concatenate([ref[:, :1], np.log(np.abs(ref[:, 1:]))], 1)
    sd = ref.std(axis=0)
    np.testing.assert_allclose(xs.mean(axis=0), ref.mean(axis=0),
                               atol=0.05 * sd.max())
    np.testing.assert_allclose(xs.std(axis=0), sd, rtol=0.05)
