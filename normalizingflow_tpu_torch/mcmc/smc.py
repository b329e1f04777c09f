"""Adaptive-tempering Sequential Monte Carlo with flow proposals.

Twin of normalizingflow_tpu/mcmc/smc.py. Particles drawn from a proposal
density q anneal along pi_beta(x) ∝ q(x)^(1-beta) * pi(x)^beta to the
target pi. Each stage picks the next beta by a 30-step bisection on the
ESS of the incremental weights, adds their log-mean-exp to the
log-evidence, resamples systematically, and mutates the particles with
`n_mutation_steps` HMC transitions at the new temperature (unit mass, step
jitter 0.2): the port's chain-batched `hmc_transition`, whose tail is the
fused accept kernel on the card. The bisection stays on the device; the
one host sync a stage is the loop's test `beta < 1 and stage < max_stages`.

Randomness comes from a `torch.Generator`, or from an iterable `draws`
consumed in this order: each stage's resampling offset u0 (a scalar in
[0, 1)), then the raw draws of each of its mutation steps
(`hmc.transition_draws`' three tensors).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import check_on, entry_device
from .hmc import (
    batched_lp_grad,
    chain_mean,
    hmc_init,
    hmc_transition,
    transition_draws,
)
from .neutra import frozen

BISECTION_STEPS = 30
STEP_JITTER = 0.2


def systematic_resampling(log_weights, n=None, u0=None, generator=None):
    """Systematic resampling: (n,) indices from one uniform offset `u0`
    (drawn from `generator` if not given). log_weights: (N,) unnormalized.
    searchsorted on the normalized CDF (side left, as jnp.searchsorted),
    clipped to N - 1."""
    n_in = log_weights.shape[0]
    n = n or n_in
    w = torch.softmax(log_weights, dim=0)
    cdf = torch.cumsum(w, dim=0)
    if u0 is None:
        u0 = torch.rand((), generator=generator, dtype=w.dtype,
                        device=w.device)
    points = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(cdf, points)
    return torch.clamp(idx, 0, n_in - 1)


def ess_from_log_weights(log_w):
    """Effective sample size of normalized importance weights."""
    log_norm = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * log_norm, dim=0))


class SMCResult(NamedTuple):
    particles: torch.Tensor      # (N, dim) final equally-weighted particles
    log_evidence: torch.Tensor   # log Z_target / Z_proposal estimate
    n_stages: int                # annealing stages taken
    final_accept: torch.Tensor   # mean HMC acceptance at the last stage


def generator_draws(generator, n, dim, n_mutation_steps, dtype, device):
    """run_smc's draws from `generator`, in the order it consumes them, for
    `n` particles: each stage's u0, then its mutation steps' draws."""
    while True:
        yield torch.rand((), generator=generator, dtype=dtype, device=device)
        for _ in range(n_mutation_steps):
            yield transition_draws(generator, n, dim, dtype, device)


def _next_beta(beta, delta, target_ess):
    """The largest beta' <= 1 whose incremental weights (beta' - beta) *
    delta keep ESS >= target_ess: bisection on the device, or 1 if even
    beta' = 1 keeps the ESS above it."""
    lo, hi = beta, torch.ones_like(beta)
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        low = ess_from_log_weights((mid - beta) * delta) < target_ess
        lo, hi = torch.where(low, lo, mid), torch.where(low, mid, hi)
    ess_at_1 = ess_from_log_weights((1.0 - beta) * delta)
    return torch.where(ess_at_1 >= target_ess, torch.ones_like(beta), lo)


def run_smc(generator, particles, proposal_logprob_fn, target_logprob_fn,
            n_mutation_steps=3, num_leapfrog=6, step_size=0.3,
            ess_fraction=0.5, max_stages=64, draws=None, device="cuda",
            mesh=None):
    """Anneal `particles` (N, dim), drawn from the proposal, to the target.

    Both log-prob functions map (N, dim) -> (N,). The step size is nudged
    after each stage toward an acceptance of ~0.65. Returns SMCResult.

    With `mesh` (parallel.Mesh), `particles` and the mutation draws are
    this rank's rows of the global set. A stage all-gathers the N
    incremental weights once; every rank then runs the bisection, the
    log-evidence and the resampling on the whole vector, with the offset u0
    of the mesh's first rank, and takes its rows of the resampled indices
    from an all-gather of the particles. The mutation's mean acceptance,
    which nudges the step size, is global. The returned particles are this
    rank's rows.
    """
    device = entry_device(device)
    check_on(device, particles)
    n, dim = particles.shape
    n_total = n if mesh is None else n * mesh.size
    dtype = particles.dtype
    inv_mass = torch.ones(dim, dtype=dtype, device=device)

    draws = iter(generator_draws(generator, n, dim, n_mutation_steps, dtype,
                                 device) if draws is None else draws)

    beta = torch.zeros((), dtype=dtype, device=device)
    log_z = torch.zeros((), dtype=dtype, device=device)
    accept = torch.zeros((), dtype=dtype, device=device)
    eps = torch.as_tensor(step_size, dtype=dtype, device=device)
    stage = 0
    while stage < max_stages and bool(beta < 1.0):
        with torch.no_grad():
            delta = target_logprob_fn(particles) \
                - proposal_logprob_fn(particles)
        u0 = next(draws)
        if mesh is not None:
            delta, u0 = mesh.all_gather(delta), mesh.broadcast(u0)
        beta_new = _next_beta(beta, delta, ess_fraction * n_total)
        log_w = (beta_new - beta) * delta
        log_z = log_z + torch.logsumexp(log_w, dim=0) - math.log(n_total)
        idx = systematic_resampling(log_w, u0=u0)
        if mesh is None:
            particles = particles[idx]
        else:
            particles = mesh.all_gather(particles)[idx[mesh.rows(n_total)]]

        def anneal_logprob(x, beta=beta_new):
            return (1.0 - beta) * proposal_logprob_fn(x) \
                + beta * target_logprob_fn(x)

        lp_grad = batched_lp_grad(anneal_logprob)
        state = hmc_init(lp_grad, particles)
        for _ in range(n_mutation_steps):
            state, info = hmc_transition(lp_grad, state, next(draws), eps,
                                         num_leapfrog, inv_mass, STEP_JITTER,
                                         inplace=True)
            accept = chain_mean(info.accept_prob, mesh)
        particles = state.position
        # crude step-size control: nudge toward ~0.65 acceptance
        eps = eps * torch.exp(torch.clamp(accept - 0.65, -0.2, 0.2))
        beta = beta_new
        stage += 1
    return SMCResult(particles=particles, log_evidence=log_z,
                     n_stages=stage, final_accept=accept)


def flow_smc(generator, flow, target, n_particles, z=None, device="cuda",
             **smc_kwargs):
    """SMC with a trained flow as the proposal: the particles start as
    `flow.sample` (of the latents `z` if given) and anneal from the flow's
    density to `target.log_prob`. The flow's parameters do not require
    grad during the run, and are restored afterwards."""
    device = entry_device(device)
    check_on(device, *flow.parameters())
    with frozen(flow):
        with torch.no_grad():
            x0, _, _ = flow.sample(n_particles, generator=generator, z=z)
        return run_smc(generator, x0, flow.log_prob, target.log_prob,
                       device=device, **smc_kwargs)
