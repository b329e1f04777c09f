"""Hamiltonian Monte Carlo over a chain batch.

Twin of normalizingflow_tpu/mcmc/hmc.py. The transition runs on the whole
(chains, dim) batch: each leapfrog step is one gradient evaluation of the
batch, and the Metropolis accept + state select, with the last half-kick
and both kinetic energies, goes through ops.hmc.accept_select_fused (one
CUDA kernel on the card). A diagonal mass matrix M gives momenta ~ N(0, M)
and kinetic energy p^T M^-1 p / 2; acceptance is exp(min(0, dH)).

Targets come in the JAX package's two conventions. A batched target maps
(chains, dim) to (chains,) log-probs (`batched_lp_grad`,
`hmc_kernel_chainbatched`, the port's default `run_hmc(batched_target=
True)`). A per-point target maps one (dim,) point to a scalar, as JAX's
default `run_hmc(batched_target=False)` takes it: `pointwise_lp_grad`
evaluates it over the batch with `torch.func.vmap`, and
`hmc_kernel_batched` is that transition. `hmc_kernel` is one chain's
transition in plain tensor ops, for `torch.func.vmap` over chains.

Randomness. Each transition takes three raw draws per chain: a jitter
uniform in [-1, 1) of shape (chains, 1), a standard-normal (chains, dim)
momentum draw and a uniform (chains,) for the accept test. They come from a
`torch.Generator`, or from an iterator passed as `draws`, so a transition
or a whole run can be replayed with the JAX package's own numbers.

The JAX package nests its scans to keep TPU trip counts small and so runs
`padded_length(n)` transitions for n requested; the port runs the same
number of transitions, and `accept_rate` is averaged over all of them, as
in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import check_on, entry_device
from ..ops.hmc import accept_select_fused
from .adaptation import (
    da_init,
    da_step_size,
    da_update,
    warmup_schedule,
    welford_init,
    welford_update_batch,
    welford_variance,
)


class HMCState(NamedTuple):
    position: torch.Tensor   # (chains, dim)
    log_prob: torch.Tensor   # (chains,)
    grad: torch.Tensor       # (chains, dim)


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    energy_change: torch.Tensor


class HMCResult(NamedTuple):
    samples: torch.Tensor        # (num_samples, chains, dim)
    log_probs: torch.Tensor      # (num_samples, chains)
    accept_rate: torch.Tensor    # scalar, sampling phase
    step_size: torch.Tensor      # adapted scalar
    inv_mass_diag: torch.Tensor  # adapted (dim,)
    final_state: HMCState


def batched_lp_grad(logprob_batch_fn):
    """(chains, dim) -> ((chains,), (chains, dim)) value and gradient.

    Per-chain log-probs decouple under a sum, so the gradient of the sum
    is each chain's own gradient, from one batched evaluation. The gradient
    is made contiguous (autograd may hand back an expanded view), as the
    accept kernel and an in-place state need."""

    def lp_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lps = logprob_batch_fn(x)
            (g,) = torch.autograd.grad(lps.sum(), x)
        return lps.detach(), g.contiguous()

    return lp_grad


def pointwise_lp_grad(logprob_fn):
    """The same for a per-point target, (dim,) -> (): `logprob_fn` and its
    gradient vmapped over the chains by torch.func. A spline flow's RQS
    kernels run once an evaluation on all chains' rows (their vmap rules,
    ops/rqs.py). Both come back detached, as `batched_lp_grad`'s do."""
    vg = torch.func.vmap(torch.func.grad_and_value(logprob_fn))

    def lp_grad(x):
        g, lp = vg(x)
        return lp.detach(), g.detach().contiguous()

    return lp_grad


def hmc_init(lp_grad, position):
    lp, grad = lp_grad(position)
    return HMCState(position, lp, grad)


def check_batched(state, batched_target):
    """Raise unless the initial state's log-probs are one a chain. A
    per-point target called on the batch returns one number for all the
    chains, whose gradient mixes them: it must be declared."""
    chains = state.position.shape[0]
    if tuple(state.log_prob.shape) != (chains,):
        form = ("a batched target, (chains, dim) -> (chains,)"
                if batched_target else "a per-point target, (dim,) -> ()")
        raise ValueError(
            f"the target returned shape {tuple(state.log_prob.shape)} for "
            f"{chains} chains, not ({chains},); batched_target="
            f"{batched_target} takes {form}. Pass batched_target=False for "
            f"a target written for one point.")


def _leapfrog_to_last_kick(lp_grad, position, momentum, grad, step_size,
                           num_steps, inv_mass_diag):
    """`leapfrog` up to, not including, its last half-kick: returns (q,
    p_half, lp, g), where the trajectory's momentum is p_half + 0.5 *
    step_size * g. Every other operation, and its order, is leapfrog's."""
    if num_steps < 1:
        raise ValueError("leapfrog needs num_steps >= 1")
    q, p, g = position, momentum, grad
    lp = None
    for i in range(num_steps):
        if i:
            p = p + 0.5 * step_size * g  # the previous step's closing kick
        p = p + 0.5 * step_size * g
        q = q + step_size * (inv_mass_diag * p)
        lp, g = lp_grad(q)
    return q, p, lp, g


def leapfrog(lp_grad, position, momentum, grad, step_size, num_steps,
             inv_mass_diag):
    """Kick-drift-kick velocity Verlet with the gradient of log pi.

    The log-prob rides along with the gradient, so an L-step trajectory
    costs exactly L gradient evaluations. Requires num_steps >= 1.
    """
    q, p, lp, g = _leapfrog_to_last_kick(lp_grad, position, momentum, grad,
                                         step_size, num_steps, inv_mass_diag)
    return q, p + 0.5 * step_size * g, lp, g


def transition_draws(generator, chains, dim, dtype, device):
    """One transition's raw draws: (jitter U[-1,1) (chains, 1), momentum
    N(0,1) (chains, dim), accept U[0,1) (chains,))."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    u_jitter = torch.rand(chains, 1, **kw) * 2.0 - 1.0
    normal = torch.randn(chains, dim, **kw)
    u_accept = torch.rand(chains, **kw)
    return u_jitter, normal, u_accept


def hmc_transition(lp_grad, state, draws, step_size, num_leapfrog,
                   inv_mass_diag, step_jitter=0.2, inplace=False):
    """One HMC transition of the whole chain batch from the raw `draws`.

    Each chain's step size is step_size * (1 + step_jitter * u) for its own
    u; the jitter breaks the periodic orbits fixed-length HMC falls into on
    near-harmonic targets. The leapfrog stops before its last half-kick:
    `accept_select_fused` completes it, takes both Hamiltonians and selects,
    in one kernel on the card. With `inplace` the new state is written into
    `state`'s own tensors (only accepted chains change), which the caller
    must own; else `state` is left as it was.
    """
    u_jitter, normal, u_accept = draws
    eps = step_size * (1.0 + step_jitter * u_jitter)
    momentum = torch.sqrt(1.0 / inv_mass_diag) * normal
    log_u = torch.log(u_accept)
    q, p_half, lp_new, g_new = _leapfrog_to_last_kick(
        lp_grad, state.position, momentum, state.grad, eps, num_leapfrog,
        inv_mass_diag)
    pos, lp, g, accept_prob, accepted, d_energy = accept_select_fused(
        q, p_half, eps, g_new, momentum, state.position, state.grad,
        state.log_prob, lp_new, log_u, inv_mass_diag, inplace=inplace)
    return HMCState(pos, lp, g), HMCInfo(accept_prob, accepted, d_energy)


def hmc_kernel(logprob_fn, step_size, num_leapfrog, inv_mass_diag,
               step_jitter=0.2):
    """One HMC transition of a single chain, `kernel(draws, state)`, for a
    per-point target; `torch.func.vmap(kernel)` runs a chain batch.

    `draws` are one chain's rows of `transition_draws`: a jitter uniform
    (1,), a standard-normal momentum (dim,) and an accept uniform (). Plain
    tensor ops, as JAX's per-chain kernel is jnp: it launches no kernel;
    `hmc_kernel_batched` gives the same transition through the accept
    kernel."""
    grad_and_value = torch.func.grad_and_value(logprob_fn)

    def lp_grad(q):
        g, lp = grad_and_value(q)
        return lp, g

    def kernel(draws, state):
        u_jitter, normal, u_accept = draws
        eps = step_size * (1.0 + step_jitter * u_jitter)
        momentum = torch.sqrt(1.0 / inv_mass_diag) * normal
        q, p, lp_new, g_new = leapfrog(lp_grad, state.position, momentum,
                                       state.grad, eps, num_leapfrog,
                                       inv_mass_diag)
        h_old = -state.log_prob + 0.5 * torch.sum(
            inv_mass_diag * momentum * momentum)
        h_new = -lp_new + 0.5 * torch.sum(inv_mass_diag * p * p)
        d_energy = h_old - h_new
        log_accept = torch.clamp(d_energy, max=0.0)
        # a divergent (NaN) proposal is rejected with accept prob 0
        finite = torch.isfinite(h_new)
        accepted = (torch.log(u_accept) < log_accept) & finite
        new_state = HMCState(torch.where(accepted, q, state.position),
                             torch.where(accepted, lp_new, state.log_prob),
                             torch.where(accepted, g_new, state.grad))
        accept_prob = torch.where(finite, torch.exp(log_accept), 0.0)
        return new_state, HMCInfo(accept_prob, accepted, d_energy)

    return kernel


def hmc_kernel_batched(logprob_fn, step_size, num_leapfrog, inv_mass_diag,
                       step_jitter=0.2):
    """One HMC transition of a chain batch for a per-point target,
    `kernel(draws, state)` with `transition_draws`' draws: the transition
    of `torch.func.vmap(hmc_kernel(...))`, its gradients vmapped
    (`pointwise_lp_grad`) and its tail the accept kernel, as JAX's routes
    through `accept_select`."""
    return _transition_kernel(pointwise_lp_grad(logprob_fn), step_size,
                              num_leapfrog, inv_mass_diag, step_jitter)


def hmc_kernel_chainbatched(logprob_batch_fn, step_size, num_leapfrog,
                            inv_mass_diag, step_jitter=0.2):
    """One HMC transition where the target sees the whole chain batch,
    (chains, dim) -> (chains,): `hmc_transition` on `batched_lp_grad`,
    as `kernel(draws, state)`."""
    return _transition_kernel(batched_lp_grad(logprob_batch_fn), step_size,
                              num_leapfrog, inv_mass_diag, step_jitter)


def _transition_kernel(lp_grad, step_size, num_leapfrog, inv_mass_diag,
                       step_jitter):
    def kernel(draws, state):
        return hmc_transition(lp_grad, state, draws, step_size, num_leapfrog,
                              inv_mass_diag, step_jitter)

    return kernel


def padded_length(length, chunk=128):
    """Transitions the JAX package runs for `length` requested: `length`
    rounded up to a multiple of `chunk` once it exceeds `chunk`."""
    if length <= chunk:
        return length
    return -(-length // chunk) * chunk


def draw_source(draws, make):
    """A function returning one transition's draws: the next item of the
    iterable `draws`, or, without it, a fresh `make()`."""
    if draws is None:
        return make
    draws = iter(draws)
    return lambda: next(draws)


def chain_mean(x, mesh=None):
    """Mean over the chain axis (dim 0): over this process's chains, or,
    with `mesh` (parallel.Mesh), over every rank's."""
    return torch.mean(x, dim=0) if mesh is None else mesh.mean(x)


def warmup(step, state, num_warmup, step_size, inv_mass_diag,
           target_accept, mesh=None):
    """Stan-style warmup of `padded_length(num_warmup)` transitions
    `step(state, eps, inv_mass) -> (state, info)`: dual averaging of the
    step size on the chain-mean `info.accept_prob`, and the windowed Welford
    mass. Pad transitions past num_warmup adapt the step size but do no
    window bookkeeping, as in JAX. With `mesh`, `state` holds this rank's
    chains and both statistics are global (`chain_mean`,
    `welford_update_batch`). Returns (state, the averaged step size, the
    inverse mass)."""
    dtype, device = state.position.dtype, state.position.device
    dim = state.position.shape[1]
    in_window, window_end = warmup_schedule(num_warmup)
    da_state = da_init(torch.as_tensor(step_size, dtype=dtype,
                                       device=device))
    wf_state = welford_init(dim, dtype, device)
    for i in range(padded_length(num_warmup)):
        state, info = step(state, da_step_size(da_state), inv_mass_diag)
        da_state = da_update(da_state, chain_mean(info.accept_prob, mesh),
                             target_accept)
        if i < num_warmup and in_window[i]:
            wf_state = welford_update_batch(wf_state, state.position, mesh)
        if i < num_warmup and window_end[i]:
            inv_mass_diag = welford_variance(wf_state)
            # restart step-size averaging around the current iterate
            da_state = da_init(da_step_size(da_state))
            wf_state = welford_init(dim, dtype, device)
    return state, da_step_size(da_state, averaged=True), inv_mass_diag


def run_hmc(generator, logprob_fn, init_position, num_samples,
            num_warmup=500, step_size=0.1, num_leapfrog=10,
            target_accept=0.8, thin=1, inv_mass_diag=None, step_jitter=0.2,
            draws=None, device="cuda", mesh=None, batched_target=True):
    """Full HMC run: warmup (adaptation) + sampling.

    `logprob_fn` maps (chains, dim) -> (chains,), or, with
    `batched_target=False` (the JAX package's default), one point (dim,)
    to a scalar; a target of the other form raises ValueError. Both run
    the same transition (`hmc_kernel_chainbatched`, `hmc_kernel_batched`).
    `init_position` is (chains, dim) on `device`. Randomness comes from
    `generator`, or from the iterator `draws` of per-transition raw draws
    (see the module docstring). With `mesh` (parallel.Mesh),
    `init_position` and the draws are this rank's chains, and the three
    statistics that cross chains (the warmup's mean acceptance, its Welford
    window, `accept_rate`) are reduced over every rank's. Returns
    HMCResult with samples (num_samples, chains, dim).
    """
    device = entry_device(device)
    check_on(device, init_position)
    chains, dim = init_position.shape
    dtype = init_position.dtype
    if inv_mass_diag is None:
        inv_mass_diag = torch.ones(dim, dtype=dtype, device=device)
    next_draws = draw_source(draws, lambda: transition_draws(
        generator, chains, dim, dtype, device))
    lp_grad = (batched_lp_grad if batched_target
               else pointwise_lp_grad)(logprob_fn)
    # The run owns its state: every transition updates it in place.
    state = hmc_init(lp_grad, init_position.clone(
        memory_format=torch.contiguous_format))
    check_batched(state, batched_target)

    def step(state, eps, inv_mass):
        return hmc_transition(lp_grad, state, next_draws(), eps,
                              num_leapfrog, inv_mass, step_jitter,
                              inplace=True)

    if num_warmup > 0:
        state, eps_final, inv_mass_diag = warmup(
            step, state, num_warmup, step_size, inv_mass_diag, target_accept,
            mesh)
    else:
        eps_final = torch.as_tensor(step_size, dtype=dtype, device=device)

    # ----------------------------------------------------------- sampling
    n_run = padded_length(num_samples)
    samples = torch.empty(num_samples, chains, dim, dtype=dtype,
                          device=device)
    log_probs = torch.empty(num_samples, chains, dtype=dtype, device=device)
    acc_sum = torch.zeros((), dtype=dtype, device=device)
    for i in range(n_run):
        state, info = step(state, eps_final, inv_mass_diag)
        acc_sum = acc_sum + chain_mean(info.accept_prob, mesh)
        for _ in range(thin - 1):
            state, _ = step(state, eps_final, inv_mass_diag)
        if i < num_samples:
            samples[i] = state.position
            log_probs[i] = state.log_prob
    return HMCResult(
        samples=samples,
        log_probs=log_probs,
        accept_rate=acc_sum / n_run,
        step_size=eps_final,
        inv_mass_diag=inv_mass_diag,
        final_state=state,
    )
