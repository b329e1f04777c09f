"""The transition's fused tail (ops/hmc.py::accept_select_fused) against the
JAX package, its in-place semantics, and the transition and run built on
it.

The reference is what the JAX chain-batched transition computes after its
last gradient: the leapfrog's last half-kick (normalizingflow_tpu/mcmc/
hmc.py:77), h_old (:253-255) and `_accept_select_ref`, or the Pallas kernel
in interpret mode. The CUDA kernel itself runs only on a GPU; chip_smoke.py
holds it against `accept_select_fused_ref` there. Tolerances are those of
tests/test_torch_ops_hmc.py (rtol 2e-6, atol 1e-6 in float32): selects and
decisions exact; d_energy, the difference of two Hamiltonians whose kinetic
sums round in another order than JAX's, relative to the size of its terms,
and accept_prob to the same relative error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.ops.hmc_pallas import (
    _accept_select_pallas,
    _accept_select_ref,
)

from normalizingflow_tpu_torch.mcmc import hmc as thmc
from normalizingflow_tpu_torch.ops.hmc import (
    _check_fused,
    accept_select_fused,
    accept_select_fused_ref,
    accept_select_ref,
)
from normalizingflow_tpu_torch.targets import NealsFunnel

torch.set_num_threads(1)

NAMES = ("pos", "lp", "grad", "accept_prob", "accepted", "d_energy")


def fused_inputs(seed, n, d, dtype=np.float32, bad_rows=True):
    """(q, p_half, eps (n, 1), g_new, momentum0, state_pos, state_grad,
    state_lp, lp_new, log_u, inv_m), drawn with numpy. Divergent rows: a
    NaN lp_new (0::7), a NaN q with an inf p_half (1::7), a NaN state_lp
    (2::7) and an inf momentum (3::7, h_old = inf: accepted)."""
    rng = np.random.default_rng(seed)
    q, p_half, g_new, pos, grad = (rng.standard_normal((n, d)).astype(dtype)
                                   for _ in range(5))
    inv_m = np.exp(0.3 * rng.standard_normal(d)).astype(dtype)
    mom = (np.sqrt(1.0 / inv_m) * rng.standard_normal((n, d))).astype(dtype)
    eps = rng.uniform(0.05, 0.3, (n, 1)).astype(dtype)
    state_lp, lp_new = (rng.standard_normal(n).astype(dtype)
                        for _ in range(2))
    log_u = np.log(rng.uniform(size=n)).astype(dtype)
    if bad_rows:
        lp_new[0::7] = np.nan
        q[1::7] = np.nan
        p_half[1::7, 0] = np.inf
        state_lp[2::7] = np.nan
        mom[3::7, 0] = np.inf
    return q, p_half, eps, g_new, mom, pos, grad, state_lp, lp_new, log_u, \
        inv_m


def to_torch(args):
    return [torch.from_numpy(a.copy()) for a in args]


def jax_tail(args, pallas=False):
    """The JAX transition's tail on the same inputs."""
    q, p_half, eps, g_new, mom, pos, grad, state_lp, lp_new, log_u, inv_m = (
        jnp.asarray(a) for a in args)
    p = p_half + 0.5 * eps * g_new
    h_old = -state_lp + 0.5 * jnp.sum(inv_m * mom * mom, axis=-1)
    select = ((lambda *a: _accept_select_pallas(*a, interpret=True))
              if pallas else _accept_select_ref)
    return select(q, p, g_new, pos, grad, lp_new, state_lp, h_old, log_u,
                  inv_m)


def term_scale(args):
    """Per row, |state_lp| + |lp_new| + both kinetic energies in float64:
    the size of the terms d_energy is the difference of. Non-finite rows
    get 0."""
    _, p_half, eps, g_new, mom, _, _, state_lp, lp_new, _, inv_m = (
        np.asarray(a, np.float64) for a in args)
    p = p_half + 0.5 * eps * g_new
    with np.errstate(invalid="ignore", over="ignore"):
        scale = (np.abs(state_lp) + np.abs(lp_new)
                 + 0.5 * np.sum(inv_m * (p * p + mom * mom), axis=-1))
    return np.nan_to_num(scale, nan=0.0, posinf=0.0)


def assert_matches(ours, ref, rtol, atol, scale):
    """Selects and decisions exact; d_energy to rtol of the terms it is the
    difference of (its two kinetic sums round in another order than JAX's),
    and accept_prob = exp(min(0, d_energy)) to that relative error."""
    for i, name in enumerate(NAMES):
        a, b = ours[i].numpy(), np.asarray(ref[i])
        if name in ("d_energy", "accept_prob"):
            tol = atol + rtol * scale * (
                1.0 if name == "d_energy" else np.nan_to_num(b))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=name)
            with np.errstate(invalid="ignore"):
                ok = (a == b) | (np.abs(a - b) <= tol)
            bad = ~ok & ~np.isnan(b)
            assert not bad.any(), (name, a[bad], b[bad], tol[bad])
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n,d", [(96, 6), (1056, 64), (64, 2048)])
def test_fused_ref_matches_jax_f32(n, d):
    args = fused_inputs(n + d, n, d)
    ours = accept_select_fused_ref(*to_torch(args))
    scale = term_scale(args)
    assert_matches(ours, jax_tail(args), 2e-6, 1e-6, scale)
    assert_matches(ours, jax_tail(args, pallas=True), 2e-6, 1e-6, scale)
    acc = ours[4].numpy()
    assert acc.dtype == np.bool_ and 0 < acc.sum() < n
    assert not acc[0::7].any() and not acc[1::7].any()
    assert not acc[2::7].any() and acc[3::7].all()
    assert (ours[3].numpy()[1::7] == 0).all()  # h_new inf: accept_prob 0


def test_fused_ref_matches_jax_f64():
    args = fused_inputs(5, 200, 10, dtype=np.float64)
    ours = accept_select_fused_ref(*to_torch(args))
    assert_matches(ours, jax_tail(args), 1e-13, 1e-13, term_scale(args))


def test_fused_is_the_old_path_bit_for_bit():
    """On CPU tensors the wrapper runs the plain version, which is the
    half-kick, h_old and accept_select_ref as the transition computed them
    before: every output equal bit for bit, and no kernel launch counted."""
    args = to_torch(fused_inputs(3, 64, 8))
    q, p_half, eps, g_new, mom, pos, grad, state_lp, lp_new, log_u, inv_m = \
        args
    p = p_half + 0.5 * eps * g_new
    h_old = -state_lp + 0.5 * torch.sum(inv_m * mom * mom, dim=-1)
    old = accept_select_ref(q, p, g_new, pos, grad, lp_new, state_lp, h_old,
                            log_u, inv_m)
    accept_select_fused.launches = 0
    for ours in (accept_select_fused(*args), accept_select_fused_ref(*args)):
        for a, b in zip(ours, old):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert accept_select_fused.launches == 0


@pytest.mark.parametrize("n,d", [(97, 12), (40, 6)])
def test_fused_in_place(n, d):
    """In place: the state's own tensors come back; accepted rows equal the
    fresh-output form and rejected rows are bit for bit what they were."""
    args = to_torch(fused_inputs(11 + n, n, d))
    fresh = accept_select_fused(*args)
    state = [t.clone() for t in args[5:8]]
    before = [t.clone() for t in state]
    ours = accept_select_fused(*args[:5], *state, *args[8:], inplace=True)
    assert ours[0] is state[0] and ours[2] is state[1]
    assert ours[1] is state[2]
    acc = fresh[4]
    assert 0 < int(acc.sum()) < n
    for a, b in zip(ours[3:], fresh[3:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for now, old, new in ((state[0], before[0], fresh[0]),
                          (state[2], before[2], fresh[1]),
                          (state[1], before[1], fresh[2])):
        torch.testing.assert_close(now[acc], new[acc], rtol=0, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(now[~acc], old[~acc], rtol=0, atol=0,
                                   equal_nan=True)
    # the inputs the state was not written into are untouched
    for a, b in zip(args, to_torch(fused_inputs(11 + n, n, d))):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("num_steps", [1, 3])
def test_leapfrog_is_the_split_plus_last_kick(num_steps):
    rng = np.random.default_rng(num_steps)
    q0, mom = (torch.from_numpy(rng.standard_normal((8, 5)))
               for _ in range(2))
    eps = torch.from_numpy(rng.uniform(0.1, 0.3, (8, 1)))
    inv_m = torch.from_numpy(rng.uniform(0.5, 2.0, 5))
    lp_grad = thmc.batched_lp_grad(NealsFunnel(5).log_prob)
    _, g0 = lp_grad(q0)
    full = thmc.leapfrog(lp_grad, q0, mom, g0, eps, num_steps, inv_m)
    q, p_half, lp, g = thmc._leapfrog_to_last_kick(lp_grad, q0, mom, g0, eps,
                                                   num_steps, inv_m)
    for a, b in zip(full, (q, p_half + 0.5 * eps * g, lp, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def funnel_state(chains=16, dim=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lp_grad = thmc.batched_lp_grad(NealsFunnel(dim).log_prob)
    pos = 0.5 * torch.randn(chains, dim, generator=gen, dtype=torch.float64)
    return gen, lp_grad, thmc.hmc_init(lp_grad, pos)


def test_transition_leaves_its_state_unless_in_place():
    gen, lp_grad, state = funnel_state()
    draws = thmc.transition_draws(gen, 16, 6, torch.float64, "cpu")
    inv_m = torch.ones(6, dtype=torch.float64)
    before = [t.clone() for t in state]
    new, info = thmc.hmc_transition(lp_grad, state, draws, 0.3, 4, inv_m)
    for a, b in zip(state, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0 < int(info.accepted.sum()) < 16

    owned = thmc.HMCState(*(t.clone() for t in state))
    new_ip, info_ip = thmc.hmc_transition(lp_grad, owned, draws, 0.3, 4,
                                          inv_m, inplace=True)
    assert all(a is b for a, b in zip(new_ip, owned))
    for a, b in zip((*new_ip, *info_ip), (*new, *info)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_run_hmc_leaves_init_position_unchanged():
    gen, _, _ = funnel_state()
    init = 0.5 * torch.randn(16, 6, generator=gen, dtype=torch.float64)
    copy = init.clone()
    res = thmc.run_hmc(gen, NealsFunnel(6).log_prob, init, 20,
                       num_warmup=10, num_leapfrog=3, device="cpu")
    torch.testing.assert_close(init, copy, rtol=0, atol=0)
    assert res.final_state.position.data_ptr() != init.data_ptr()
    assert not torch.equal(res.final_state.position, init)  # chains moved
    torch.testing.assert_close(res.samples[-1], res.final_state.position,
                               rtol=0, atol=0)


def test_fused_input_checks():
    """What the CUDA wrapper validates before launching, checked on CPU
    tensors (the checks are pure Python)."""
    args = to_torch(fused_inputs(4, 32, 8))

    def check(a, inplace=False):
        return _check_fused(*a, inplace)

    assert check(args) == (32, 8, True)
    assert check(to_torch(fused_inputs(4, 32, 6)))[2] is False  # D % 4
    with pytest.raises(TypeError, match="float32"):
        check([a.double() for a in args])
    for i, new, match in (
            (2, args[2].reshape(-1), "eps"),                # (n,) not (n, 1)
            (4, args[4].t().contiguous().t(), "contiguous"),  # momentum0
            (10, args[10][:4], "inv_mass_diag"),
            (7, args[7][:5], "state_lp"),
            (1, torch.empty((32, 8), device="meta"), "p_half on meta")):
        bad = list(args)
        bad[i] = new
        with pytest.raises(ValueError, match=match):
            check(bad)
    with pytest.raises(ValueError, match="chains, dim"):
        check(to_torch(fused_inputs(4, 0, 8)))
    aliased = list(args)
    aliased[5] = args[0]  # q is the state's position
    check(aliased)        # fine into fresh outputs
    with pytest.raises(ValueError, match="share memory"):
        check(aliased, inplace=True)
