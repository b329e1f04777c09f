"""Parity of the port's spline flows and particle priors with the JAX
package, in float64.

The layers (SplineCoupling under every mask kind, SplineAR periodic, plain
and with asymmetric bounds, MaskedAffineAR) take the JAX init, perturbed,
through `params.from_jax`; inputs come from numpy. Outputs, log-dets and
parameter gradients match at rtol 1e-10 / 1e-9 (the packages differ only
in the order of floating-point sums). A small NSF_CL NeuTra run replays
JAX's own draws, as tests/test_torch_hmc.py does for RealNVP.
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
from normalizingflow_tpu.mcmc.hmc import run_hmc as j_run_hmc
from normalizingflow_tpu.mcmc.neutra import neutra_hmc as j_neutra_hmc
from normalizingflow_tpu.mcmc.neutra import (
    pullback_logprob_batched as j_pullback,
)
from normalizingflow_tpu.mcmc.hmc import padded_length as j_padded_length
from normalizingflow_tpu.targets import NealsFunnel as JFunnel
from normalizingflow_tpu.train.objectives import reverse_kl as j_reverse_kl

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.mcmc import (
    pullback_logprob_batched,
    push_to_data,
    run_hmc,
)
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.train.loop import bench_optimizer
from normalizingflow_tpu_torch.train.objectives import reverse_kl

torch.set_num_threads(1)

SIZE, SPACE, K, B, HIDDEN = 4, 3, 8, 3.0, 16
DIM = SIZE * SPACE
AR_DIM, BATCH = 5, 24
RTOL, ATOL = 1e-10, 1e-12
F64 = dict(dtype=torch.float64, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().numpy()
    np.testing.assert_allclose(actual, np.asarray(expected), rtol=rtol,
                               atol=atol, err_msg=msg)


def perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a))),
        tree)


LAYERS = ["cl_mask0", "cl_mask1", "cl_mask2", "cl_mask01", "cl_mask02",
          "cl_mask12", "ar_periodic", "ar_plain", "ar_asymmetric", "maf"]


def layer_pair(kind):
    """(JAX layer, port layer, input width, input scale)."""
    if kind.startswith("cl_"):
        mask = tuple(int(c) for c in kind[len("cl_mask"):])
        kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN, mask=mask)
        return (jb.SplineCoupling(SIZE, SPACE, **kw),
                tb.SplineCoupling(SIZE, SPACE, **kw, **F64), DIM, 1.5)
    if kind.startswith("ar_"):
        kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN,
                  periodic=kind != "ar_plain")
        if kind == "ar_asymmetric":
            kw.update(input_bounds=(-2.0, 3.5), output_bounds=(-1.0, 2.0))
        return (jb.SplineAR(AR_DIM, **kw), tb.SplineAR(AR_DIM, **kw, **F64),
                AR_DIM, 1.5)
    if kind == "maf":
        return (jb.MaskedAffineAR(AR_DIM, hidden_dim=8),
                tb.MaskedAffineAR(AR_DIM, hidden_dim=8, **F64), AR_DIM, 1.0)
    raise ValueError(kind)


def loaded_pair(kind, seed=1):
    jl, tl, dim, scale = layer_pair(kind)
    p = perturbed(jl.init(jax.random.PRNGKey(seed)), seed)
    tparams.from_jax(tl, p)
    x = np.random.default_rng(seed).standard_normal((BATCH, dim)) * scale
    return jl, tl, p, x


def named_grads(module):
    return {n: prm.grad.numpy() for n, prm in module.named_parameters()}


def jax_named(tree):
    return {".".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", LAYERS)
def test_layer_matches_jax(kind):
    jl, tl, p, x = loaded_pair(kind)
    jy, jld = jl.forward(p, jnp.asarray(x))
    ty, tld = tl.forward(t(x))
    close(ty, jy)
    close(tld, jld)
    jx, jild = jl.inverse(p, jy)
    tx, tild = tl.inverse(ty)
    close(tx, jx)
    close(tild, jild)
    close(tx, x, rtol=1e-9, atol=1e-9)      # round trip
    close(tld + tild, np.zeros(BATCH), atol=1e-9)


@pytest.mark.parametrize("kind", LAYERS)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_layer_param_grads_match_jax(kind, direction):
    jl, tl, p, x = loaded_pair(kind, seed=2)
    rng = np.random.default_rng(3)
    cy = rng.standard_normal(x.shape)
    cld = rng.standard_normal(BATCH)

    def jloss(q):
        y, ld = getattr(jl, direction)(q, jnp.asarray(x))
        return jnp.sum(cy * y) + jnp.sum(cld * ld)

    jgrad = jax_named(jax.grad(jloss)(p))
    y, ld = getattr(tl, direction)(t(x))
    (torch.sum(t(cy) * y) + torch.sum(t(cld) * ld)).backward()
    tgrad = named_grads(tl)
    assert set(tgrad) == set(jgrad)
    for name, g in jgrad.items():
        close(tgrad[name], g, rtol=1e-9, atol=1e-11, msg=name)


@pytest.mark.parametrize("kind", LAYERS)
def test_params_bridge_round_trip(kind):
    jl, tl, p, _ = loaded_pair(kind)
    back = tparams.to_numpy(tl)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("periodic", [True, False])
def test_ar_masks_and_init_match_jax(periodic):
    """The stacked conditioners' row masks are JAX's, and each MLP's first
    layer fills its effective fan-in bound, 1/sqrt((2 if periodic else 1)*i),
    on visible rows."""
    jl = jb.SplineAR(AR_DIM, num_bins=K, hidden_dim=64, periodic=periodic)
    tl = tb.SplineAR(AR_DIM, num_bins=K, hidden_dim=64, periodic=periodic,
                     generator=torch.Generator().manual_seed(0), **F64)
    np.testing.assert_array_equal(tl.cond.row_masks.numpy(),
                                  np.asarray(jl.cond.row_masks()))
    w1 = tl.cond.w1.detach().numpy()
    for i in range(1, AR_DIM):
        bound = 1.0 / np.sqrt((2.0 if periodic else 1.0) * i)
        assert np.abs(w1[i - 1]).max() <= bound
        assert np.abs(w1[i - 1]).max() > 0.9 * bound
    assert np.abs(tl.init_raw.detach().numpy()).max() <= 0.5


def test_ar_dim1_has_no_conditioner():
    jl, tl = jb.SplineAR(1, num_bins=K), tb.SplineAR(1, num_bins=K, **F64)
    p = perturbed(jl.init(jax.random.PRNGKey(0)), 0)
    tparams.from_jax(tl, p)
    x = np.random.default_rng(0).standard_normal((BATCH, 1))
    close(tl.forward(t(x))[0], jl.forward(p, jnp.asarray(x))[0])
    close(tl.inverse(t(x))[1], jl.inverse(p, jnp.asarray(x))[1])


def test_spline_ar_dim1_round_trips():
    """tests/test_bijectors.py's dim-1 SplineAR: inverse(forward(x)) is x
    and the log-dets cancel, on JAX's init."""
    jl, tl = jb.SplineAR(1, num_bins=5, tail_bound=3.0, hidden_dim=8), \
        tb.SplineAR(1, num_bins=5, tail_bound=3.0, hidden_dim=8, **F64)
    tparams.from_jax(tl, jl.init(jax.random.PRNGKey(4)))
    x = t(np.random.default_rng(4).standard_normal((BATCH, 1)))
    with torch.no_grad():
        y, ld = tl.forward(x)
        x2, ld_inv = tl.inverse(y)
    assert y.shape == x.shape and ld.shape == (BATCH,)
    close(x2, x, rtol=0, atol=1e-8)
    close(ld + ld_inv, np.zeros(BATCH), rtol=0, atol=1e-8)


# ------------------------------- the SplineAR inverse's two paths
@pytest.fixture
def inverse_paths(monkeypatch):
    """SplineAR's counter of inverses a path, from 0 for this test."""
    counts = {"buffered": 0, "stacked": 0}
    monkeypatch.setattr(tb.SplineAR, "inverse_paths", counts)
    return counts


def ar_layers(kind, dim, depth, dtype, seed=5):
    """`depth` SplineAR layers of `kind` (a Chain if more than one) and
    latents inside the tail bound."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN,
              periodic=kind != "plain", generator=gen, dtype=dtype)
    if kind == "asymmetric":
        kw.update(input_bounds=(-2.0, 3.5), output_bounds=(-1.0, 2.0))
    layers = [tb.SplineAR(dim, **kw) for _ in range(depth)]
    flow = layers[0] if depth == 1 else tb.Chain(layers)
    lo, hi = kw.get("output_bounds", (-B, B))
    z = lo + (hi - lo) * (0.05 + 0.9 * torch.rand(
        BATCH, dim, generator=gen, dtype=dtype))
    return flow, z


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dim", [2, 3, 7])
@pytest.mark.parametrize("kind", ["periodic", "plain", "asymmetric"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_spline_ar_buffered_inverse_is_the_stacked_bits(
        inverse_paths, dtype, kind, dim, depth):
    flow, z = ar_layers(kind, dim, depth, dtype)
    x_st, ld_st = flow.inverse(z)
    assert inverse_paths == {"buffered": 0, "stacked": depth}
    with torch.no_grad():
        x_bu, ld_bu = flow.inverse(z)
    assert inverse_paths == {"buffered": depth, "stacked": depth}
    assert x_bu.shape == (BATCH, dim) and x_bu.is_contiguous()
    assert torch.equal(x_bu, x_st.detach())
    assert torch.equal(ld_bu, ld_st.detach())


@pytest.mark.parametrize("kind", ["ar_periodic", "ar_plain", "ar_asymmetric"])
def test_spline_ar_buffered_inverse_matches_jax(inverse_paths, kind):
    jl, tl, p, x = loaded_pair(kind)
    jy, _ = jl.forward(p, jnp.asarray(x))
    jx, jild = jl.inverse(p, jy)
    with torch.no_grad():
        tx, tild = tl.inverse(t(np.asarray(jy)))
    assert inverse_paths == {"buffered": 1, "stacked": 0}
    close(tx, jx)
    close(tild, jild)
    close(tx, x, rtol=1e-9, atol=1e-9)      # round trip


def _inverse_under(case, layer, z):
    if case == "no_grad":
        with torch.no_grad():
            return layer.inverse(z)
    if case == "inference_mode":
        with torch.inference_mode():
            return layer.inverse(z)
    if case == "param_grad":
        return layer.inverse(z)
    layer.requires_grad_(False)
    if case == "frozen":
        return layer.inverse(z)
    if case == "z_grad_frozen":
        return layer.inverse(z.clone().requires_grad_(True))
    if case == "vmap_no_grad":
        with torch.no_grad():
            return torch.func.vmap(lambda zi: tuple(
                v[0] for v in layer.inverse(zi[None])))(z)
    raise ValueError(case)


@pytest.mark.parametrize("case, path", [
    ("no_grad", "buffered"), ("inference_mode", "buffered"),
    ("frozen", "buffered"), ("param_grad", "stacked"),
    ("z_grad_frozen", "stacked"), ("vmap_no_grad", "stacked")])
def test_spline_ar_inverse_path_follows_what_records_it(inverse_paths, case,
                                                        path):
    """Buffered only where nothing records the inverse: grad mode off, or
    neither z nor a parameter requiring grad, and no torch.func
    transform."""
    layer, z = ar_layers("periodic", 4, 1, torch.float64)
    with torch.no_grad():
        x_ref, ld_ref = layer.inverse(z)
    inverse_paths.update(buffered=0, stacked=0)
    x, ld = _inverse_under(case, layer, z)
    assert inverse_paths == {"buffered": int(path == "buffered"),
                             "stacked": int(path == "stacked")}
    close(x, x_ref.numpy(), rtol=1e-13, atol=1e-14)
    close(ld, ld_ref.numpy(), rtol=1e-13, atol=1e-14)


# ---------------------------------------- the Fe-shaped stack in float32
# tests/test_f32_stack.py: 2 x SplineAR at the Fe config's widths (54
# particles x 3, 32 bins, hidden 354, periodic, tail bound the Fe_400K box
# half-length), in float32 against the same params in float64, with that
# file's bounds.
F32_DIM, F32_BINS, F32_HIDDEN, F32_BATCH = 162, 32, 354, 256
F32_TAIL = 3.0 * 2.9115 / 2.0


@pytest.fixture(scope="module")
def f32_stack():
    """(float32 stack, float64 stack, x): JAX's init (f32 leaves) in both,
    x JAX's uniform draws inside 0.95 of the tail bound."""
    jchain = jb.Chain([jb.SplineAR(F32_DIM, num_bins=F32_BINS,
                                   tail_bound=F32_TAIL, hidden_dim=F32_HIDDEN,
                                   periodic=True) for _ in range(2)])
    params = jchain.init(jax.random.PRNGKey(0))
    x = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(1), (F32_BATCH, F32_DIM), jnp.float32,
        -0.95 * F32_TAIL, 0.95 * F32_TAIL))

    def stack(dtype):
        chain = tb.Chain([tb.SplineAR(F32_DIM, num_bins=F32_BINS,
                                      tail_bound=F32_TAIL,
                                      hidden_dim=F32_HIDDEN, periodic=True,
                                      dtype=dtype) for _ in range(2)])
        return tparams.from_jax(chain, params)

    return stack(torch.float32), stack(torch.float64), torch.tensor(x)


def test_f32_roundtrip_at_scale(f32_stack):
    s32, _, x = f32_stack
    with torch.no_grad():
        z, ld = s32.forward(x)
        x_back, ld_inv = s32.inverse(z)
    assert z.dtype == ld.dtype == torch.float32
    close(x_back, x, rtol=0, atol=5e-4)
    close(ld + ld_inv, np.zeros(F32_BATCH), rtol=0, atol=5e-3)


def test_f32_matches_f64_at_scale(f32_stack):
    s32, s64, x = f32_stack
    with torch.no_grad():
        z32, ld32 = s32.forward(x)
        z64, ld64 = s64.forward(x.double())
    close(z32, z64, rtol=0, atol=2e-3)
    close(ld32, ld64, rtol=1e-4, atol=2e-2)


def test_f32_inverse_matches_f64_at_scale(f32_stack):
    s32, s64, z = f32_stack
    with torch.no_grad():
        x32, ld32 = s32.inverse(z)
        x64, ld64 = s64.inverse(z.double())
    close(x32, x64, rtol=0, atol=5e-3)
    close(ld32, ld64, rtol=1e-4, atol=5e-2)


# ------------------------------------------------------- the NSF_CL flow
def build_flows(seed=3):
    """The bench's spline stack (3 SplineCoupling layers, masks (0,), (1,),
    (2,)) at a small size, in both packages, with shared params."""
    kw = dict(num_bins=K, tail_bound=B, hidden_dim=HIDDEN)
    jflow = JFlow(jd.DiagNormal(DIM), jb.Chain(
        [jb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw) for a in range(3)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Chain(
        [tb.SplineCoupling(SIZE, SPACE, mask=(a,), **kw, **F64)
         for a in range(3)]))
    p = perturbed(jflow.init(jax.random.PRNGKey(seed)), seed, scale=0.3)
    tparams.from_jax(tflow, p)
    return jflow, p, tflow


def test_spline_flow_reverse_kl_and_grads_match_jax():
    jflow, p, tflow = build_flows()
    jtarget, ttarget = JFunnel(DIM), NealsFunnel(DIM)
    key = jax.random.PRNGKey(6)
    z = jflow.prior.sample(key, BATCH)
    jloss, jgrad = jax.value_and_grad(
        lambda q: j_reverse_kl(jflow, q, jtarget, key, BATCH))(p)
    tloss = reverse_kl(tflow, ttarget, z=t(z))
    tloss.backward()
    close(tloss, jloss)
    grads = named_grads(tflow)
    flat = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert len(flat) == len(grads)
    for path, g in flat:
        name = ".".join(["bijector.bijectors", str(path[0].idx)]
                        + [k.key for k in path[1:]])
        close(grads[name], g, rtol=1e-9, atol=1e-11, msg=name)


def test_spline_line_schedule_matches_optax():
    """The spline line's optimizer: peak 5e-4, warmup 300, over 2250."""
    ref = optax.warmup_cosine_decay_schedule(0.0, 5e-4, warmup_steps=300,
                                             decay_steps=2250)
    prm = [torch.nn.Parameter(torch.zeros(2, **F64))]
    ours = bench_optimizer(prm, 2250, warmup_steps=300, peak_lr=5e-4)
    for k in (0, 1, 150, 299, 300, 301, 1000, 2249, 2250):
        close(ours.schedule(k), float(ref(k)), rtol=1e-6, atol=1e-12,
              msg=f"step {k}")


def jax_run_draws(key, chains, dim, num_warmup, num_samples):
    """Every transition's raw draws (jitter u (chains, 1), momentum normals
    (chains, dim), accept u (chains,)) in the order JAX's chain-batched
    run_hmc consumes them (thin 1)."""
    @jax.jit
    def draws(k):
        def one(kc):
            k_mom, k_acc, k_eps = jax.random.split(kc, 3)
            return (jax.random.uniform(k_eps, (), jnp.float64, -1.0, 1.0),
                    jax.random.normal(k_mom, (dim,), jnp.float64),
                    jax.random.uniform(k_acc, (), jnp.float64))
        u, normal, ua = jax.vmap(one)(jax.random.split(k, chains))
        return u[:, None], normal, ua

    keys = []
    if num_warmup > 0:
        k_warm, key = jax.random.split(key)
        keys += list(jax.random.split(k_warm, j_padded_length(num_warmup)))
    keys += list(jax.random.split(key, j_padded_length(num_samples)))
    return [tuple(t(a) for a in draws(k)) for k in keys]


def test_neutra_spline_run_matches_jax():
    """JAX's neutra_hmc on the NSF_CL flow against the port's run_hmc on
    the chain-batched pullback fed JAX's own chain inits and draws, then
    the port's chunked push. A fixed step: with dual averaging the two runs
    part at ~1e-6 within ten transitions, the rounding amplification
    ROADMAP Queue 3 records for RealNVP."""
    jflow, p, tflow = build_flows()
    chains, draws_n, warmup = 16, 8, 0
    kw = dict(num_warmup=warmup, step_size=0.01, num_leapfrog=4)
    key = jax.random.PRNGKey(11)
    jres = j_neutra_hmc(key, jflow, p, JFunnel(DIM), chains, draws_n, **kw)
    k_init, k_run = jax.random.split(key)
    z0 = jflow.prior.sample(k_init, chains)
    draws = jax_run_draws(k_run, chains, DIM, warmup, draws_n)
    tres = run_hmc(None, pullback_logprob_batched(tflow, NealsFunnel(DIM)),
                   t(z0), draws_n, draws=draws, device="cpu", **kw)
    xs = push_to_data(tflow, tres.samples, chunk=10)
    close(tres.samples, jres.samples_z, rtol=1e-8, atol=1e-10)
    close(xs, jres.samples_x, rtol=1e-8, atol=1e-10)
    close(tres.accept_rate, jres.accept_rate, rtol=1e-8)
    close(tres.step_size, jres.step_size, rtol=1e-8)
    assert 0.5 < float(tres.accept_rate) < 0.95  # mixed accepts


def test_push_chunked_equals_unchunked():
    """Rows are independent, so the chunk size changes no value. The CPU's
    matrix products may sum a one-row chunk in another order than a full
    block, hence equality to 1e-14 and not bit for bit."""
    _, _, tflow = build_flows()
    zs = t(np.random.default_rng(8).standard_normal((7, 9, DIM)) * 1.5)
    whole = push_to_data(tflow, zs, chunk=10**9)
    with torch.no_grad():
        direct = tflow.inverse(zs.reshape(-1, DIM))[0].reshape(zs.shape)
    assert torch.equal(whole, direct)
    for chunk in (1, 5, 16, 62, 63):
        torch.testing.assert_close(push_to_data(tflow, zs, chunk=chunk),
                                   whole, rtol=1e-14, atol=1e-14)


# ------------------------------------------------------- particle priors
def test_gaussian_mixture_matches_jax():
    centers = [[0.5, -0.25], [-1.0, 0.75], [0.0, 2.0]]
    # JAX keeps centers and vars in float32 even under x64, so its
    # normalizing term log(2 pi) + log(vars) is a float32 sum: log_prob
    # agrees to float32 rounding of that constant (1e-8 relative). With
    # unit vars it is common to all components and drops out of the force,
    # which agrees at 1e-10; with unequal vars it weighs the components.
    for vars, force_tol in ((1.0, (RTOL, 1e-12)),
                            ([0.25, 1.0, 4.0], (1e-6, 1e-8))):
        jm = jd.GaussianMixture(centers, vars, npoints=5, point_dim=2)
        tm = td.GaussianMixture(centers, vars, npoints=5, point_dim=2, **F64)
        x = np.random.default_rng(9).standard_normal((BATCH, 10)) * 1.5
        close(tm.log_prob(t(x)), jm.log_prob(jnp.asarray(x)), rtol=5e-8,
              atol=0)
        close(tm.force(t(x)), jm.force(jnp.asarray(x)), *force_tol)
    draws = tm.sample(40000, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (40000, 10) and draws.dtype == torch.float64
    ref = np.asarray(jm.sample(jax.random.PRNGKey(0), 40000))
    close(draws.mean(0), ref.mean(0), rtol=0, atol=0.05)
    close(draws.std(0), ref.std(0), rtol=0.03)


@pytest.mark.parametrize("boxlength", [None, 2.0])
def test_einstein_crystal_matches_jax(boxlength):
    rng = np.random.default_rng(10)
    centers = rng.uniform(-0.9, 0.9, (4, 3)).astype(np.float32)
    jc = jd.EinsteinCrystal(centers, alpha=50.0, boxlength=boxlength)
    tc = td.EinsteinCrystal(centers.astype(np.float64), alpha=50.0,
                            boxlength=boxlength, **F64)
    # deviations up to 1.8: with the box they wrap past half its length
    x = (centers.reshape(1, -1).astype(np.float64)
         + rng.uniform(-1.8, 1.8, (BATCH, 12)))
    close(tc.log_prob(t(x)), jc.log_prob(jnp.asarray(x)))
    if boxlength is not None:
        unwrapped = td.EinsteinCrystal(centers.astype(np.float64), alpha=50.0,
                                       **F64)
        assert not torch.allclose(tc.log_prob(t(x)),
                                  unwrapped.log_prob(t(x)))
    draws = tc.sample(20000, generator=torch.Generator().manual_seed(1))
    ref = np.asarray(jc.sample(jax.random.PRNGKey(1), 20000))
    assert draws.shape == ref.shape == (20000, 12)
    if boxlength is None:
        close(draws.mean(0), ref.mean(0), rtol=0, atol=0.01)
        close(draws.std(0), ref.std(0), rtol=0.03)
    else:  # wrapped into the box; compare the law through the density
        assert float(draws.abs().max()) <= boxlength / 2
        close(tc.log_prob(draws).mean(), jc.log_prob(ref).mean(), rtol=0,
              atol=0.1)
