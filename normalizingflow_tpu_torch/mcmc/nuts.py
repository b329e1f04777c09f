"""No-U-Turn Sampler over a chain batch.

Twin of normalizingflow_tpu/mcmc/nuts.py in the form that `jax.vmap` of its
`nuts_kernel` gives: the iterative tree builder (Phan & Pradhan, as in
NumPyro and Stan) with a checkpoint stack of max_depth + 1 states,
multinomial sampling within a subtree, biased progressive sampling across
the doublings, the divergence guard at |dH| > 1000 and a diagonal mass
matrix. `run_nuts` has `run_hmc`'s warmup and interface. The target is
batched, (chains, dim) -> (chains,), or, with `batched_target=False`, per
point, (dim,) -> () (the only form JAX's run_nuts takes; `nuts_kernel`);
each leaf is one gradient evaluation of the whole batch.

Batching. Under vmap a while_loop runs while any chain's condition holds,
and a chain whose condition fails keeps its carry. So here:
  * the doubling loop runs while any chain is active. A chain stops at
    max_depth or when it turns or diverges, and is frozen from then on. All
    active chains share one depth, the loop index, so a subtree has
    2**depth leaves, a host int;
  * inside a subtree all chains still going share the leaf index n, so the
    checkpoint slot popcount(n) and the U-turn slot range
    [popcount(n) - trailing_ones(n), popcount(n) - 1] are host ints. A chain
    that turns or diverges stops; the others go on.
Every leaf makes one batched gradient call (the frozen chains' rows are
computed and discarded) and one host sync, "is any chain still going?", so
a subtree ends with its last chain. Frozen rows are selected away with
`torch.where`, so a NaN in one chain reaches no other.

Randomness. A transition takes a momentum normal (chains, dim); at each
depth d a direction bit and a cross-subtree take-uniform, each (chains,);
at each leaf n of depth d a within-subtree proposal uniform (chains,).
`TransitionDraws` makes them from a torch.Generator when they are first
asked for, so unused depths cost nothing; `run_nuts(draws=...)` takes any
objects with the same four methods (the tests pass JAX's own numbers).

JAX's behaviour is matched, not fixed (ROADMAP Queue 3): a non-finite leaf
energy gets log-weight -inf and accept 0 and sets `diverged`; `diverged` is
overwritten at each leaf and depth, not or-ed; the merged tree's U-turn
check looks at its endpoints only; accept_prob is sum_accept /
max(n_leapfrog, 1); and run_nuts runs `padded_length` warmup and sampling
transitions and divides its rates by the padded count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import check_on, entry_device
from .hmc import (
    HMCState,
    batched_lp_grad,
    check_batched,
    draw_source,
    hmc_init,
    padded_length,
    pointwise_lp_grad,
    warmup,
)

MAX_DELTA_ENERGY = 1000.0


class _Z(NamedTuple):
    """Phase-space points of the chain batch."""
    q: torch.Tensor      # (chains, dim)
    p: torch.Tensor      # (chains, dim)
    grad: torch.Tensor   # (chains, dim)
    logp: torch.Tensor   # (chains,)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (chains,)
    diverged: torch.Tensor     # (chains,) bool
    depth: torch.Tensor        # (chains,) int32
    n_leapfrog: torch.Tensor   # (chains,) int32


class NUTSResult(NamedTuple):
    samples: torch.Tensor        # (num_samples, chains, dim)
    log_probs: torch.Tensor      # (num_samples, chains)
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    inv_mass_diag: torch.Tensor
    mean_depth: torch.Tensor
    divergence_rate: torch.Tensor
    final_state: HMCState


class TransitionDraws:
    """One transition's raw draws from `generator`, made when first asked
    for: momentum() (chains, dim) N(0, 1); direction(d) (chains,) bool,
    True to go right (uniform < 0.5, as JAX's bernoulli); take(d) and
    leaf(d, n) (chains,) U[0, 1)."""

    def __init__(self, generator, chains, dim, dtype, device):
        self.kw = dict(generator=generator, dtype=dtype, device=device)
        self.chains, self.dim = chains, dim

    def momentum(self):
        return torch.randn(self.chains, self.dim, **self.kw)

    def direction(self, depth):
        return torch.rand(self.chains, **self.kw) < 0.5

    def take(self, depth):
        return torch.rand(self.chains, **self.kw)

    def leaf(self, depth, n):
        return torch.rand(self.chains, **self.kw)


def popcount(n):
    return bin(n).count("1")


def trailing_ones(n):
    """Number of trailing 1 bits of n: popcount(n & ~(n + 1))."""
    return popcount(n & ~(n + 1))


def _where(mask, a, b):
    """Per chain, a where `mask` else b, field by field."""
    return type(a)(*(torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)
                     for x, y in zip(a, b)))


def _leapfrog_one(lp_grad, z, eps, inv_mass):
    p = z.p + 0.5 * eps * z.grad
    q = z.q + eps * inv_mass * p
    logp, grad = lp_grad(q)
    p = p + 0.5 * eps * grad
    return _Z(q, p, grad, logp)


def _energy(z, inv_mass):
    return -z.logp + 0.5 * torch.sum(inv_mass * z.p * z.p, dim=-1)


def _is_turning(q_left, p_left, q_right, p_right, inv_mass):
    dq = q_right - q_left
    return ((torch.sum(dq * (inv_mass * p_left), dim=-1) <= 0.0)
            | (torch.sum(dq * (inv_mass * p_right), dim=-1) <= 0.0))


class _Subtree(NamedTuple):
    z_end: _Z              # running end of the subtree
    z_prop: _Z             # the subtree's multinomial proposal
    log_sum_w: torch.Tensor
    sum_accept: torch.Tensor
    leaf: torch.Tensor     # leaves built
    turning: torch.Tensor
    diverged: torch.Tensor


def _build_subtree(lp_grad, z_start, depth, eps, inv_mass, h0, active,
                   draws, q_ckpt, p_ckpt):
    """2**depth leapfrog leaves from z_start (eps already signed) for the
    chains in `active`; the others come back as they went in. q_ckpt and
    p_ckpt, (max_depth + 1, chains, dim), are the checkpoint stacks, which
    this overwrites."""
    chains = h0.shape[0]
    dtype, device = h0.dtype, h0.device
    z_end = z_prop = z_start
    log_sum_w = torch.full((chains,), -torch.inf, dtype=dtype, device=device)
    sum_accept = torch.zeros(chains, dtype=dtype, device=device)
    leaf = torch.zeros(chains, dtype=torch.int32, device=device)
    turning = torch.zeros(chains, dtype=torch.bool, device=device)
    diverged = torch.zeros_like(turning)
    going = active
    for n in range(2 ** depth):
        if not bool(going.any()):
            break
        z = _leapfrog_one(lp_grad, z_end, eps, inv_mass)
        h = _energy(z, inv_mass)
        # NaN guard: a non-finite leaf energy gets weight exp(-inf) = 0 and
        # accept 0, not NaN, and marks the chain diverged
        finite = torch.isfinite(h) & torch.isfinite(h0)
        dh = torch.where(finite, h0 - h, -torch.inf)  # log multinomial weight
        div = ~finite | (h - h0 > MAX_DELTA_ENERGY)
        accept = torch.where(finite, torch.exp(torch.clamp(dh, max=0.0)),
                             0.0)
        lsw = torch.logaddexp(log_sum_w, dh)
        take = torch.log(draws.leaf(depth, n)) < dh - lsw
        z_prop = _where(going & take, z, z_prop)
        pc = popcount(n)
        if n % 2 == 0:  # even leaves are stored at slot popcount(n)
            g = going[:, None]
            q_ckpt[pc] = torch.where(g, z.q, q_ckpt[pc])
            p_ckpt[pc] = torch.where(g, z.p, p_ckpt[pc])
            turn = torch.zeros_like(going)
        else:  # odd leaves check every subtree that ends at n
            turn = torch.zeros_like(going)
            for s in range(pc - trailing_ones(n), pc):
                turn = turn | _is_turning(q_ckpt[s], p_ckpt[s], z.q, z.p,
                                          inv_mass)
        z_end = _where(going, z, z_end)
        log_sum_w = torch.where(going, lsw, log_sum_w)
        sum_accept = torch.where(going, sum_accept + accept, sum_accept)
        leaf = leaf + going.to(torch.int32)
        turning = torch.where(going, turn, turning)
        diverged = torch.where(going, div, diverged)
        going = going & ~turning & ~diverged
    return _Subtree(z_end, z_prop, log_sum_w, sum_accept, leaf, turning,
                    diverged)


def nuts_transition(lp_grad, state, draws, step_size, inv_mass_diag,
                    max_depth=10):
    """One NUTS transition of the chain batch from `draws` (see the module
    docstring). `lp_grad` maps (chains, dim) to their log-probs and
    gradients (`batched_lp_grad`). Returns (HMCState, NUTSInfo)."""
    q0 = state.position
    chains, dim = q0.shape
    dtype, device = q0.dtype, q0.device
    step = torch.as_tensor(step_size, dtype=dtype, device=device)
    p0 = torch.sqrt(1.0 / inv_mass_diag) * draws.momentum()
    z0 = _Z(q0, p0, state.grad, state.log_prob)
    h0 = _energy(z0, inv_mass_diag)

    z_left = z_right = z_prop = z0
    log_sum_w = torch.zeros(chains, dtype=dtype, device=device)  # z0: exp(0)
    sum_accept = torch.zeros(chains, dtype=dtype, device=device)
    depth = torch.zeros(chains, dtype=torch.int32, device=device)
    n_leapfrog = torch.zeros_like(depth)
    turning = torch.zeros(chains, dtype=torch.bool, device=device)
    diverged = torch.zeros_like(turning)
    q_ckpt = torch.zeros(max_depth + 1, chains, dim, dtype=dtype,
                         device=device)
    p_ckpt = torch.zeros_like(q_ckpt)
    active = ~turning
    for d in range(max_depth):
        if not bool(active.any()):
            break
        go_right = draws.direction(d)
        eps = torch.where(go_right, step, -step)[:, None]
        sub = _build_subtree(lp_grad, _where(go_right, z_right, z_left), d,
                             eps, inv_mass_diag, h0, active, draws, q_ckpt,
                             p_ckpt)
        # the new endpoint on the chosen side
        left = _where(go_right, z_left, sub.z_end)
        right = _where(go_right, sub.z_end, z_right)
        ok = ~sub.turning & ~sub.diverged
        # biased progressive sampling across the doubling
        take_new = ok & (torch.log(draws.take(d))
                         < sub.log_sum_w - log_sum_w)
        prop = _where(take_new, sub.z_prop, z_prop)
        # the merged tree's U-turn check, on its endpoints
        merged = _is_turning(left.q, left.p, right.q, right.p, inv_mass_diag)

        z_left = _where(active, left, z_left)
        z_right = _where(active, right, z_right)
        z_prop = _where(active, prop, z_prop)
        log_sum_w = torch.where(
            active, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w)
        depth = depth + active.to(torch.int32)
        turning = torch.where(active, sub.turning | merged, turning)
        diverged = torch.where(active, sub.diverged, diverged)
        sum_accept = torch.where(active, sum_accept + sub.sum_accept,
                                 sum_accept)
        n_leapfrog = n_leapfrog + sub.leaf  # 0 for the frozen chains
        active = active & ~turning & ~diverged

    accept_prob = sum_accept / torch.clamp(n_leapfrog.to(dtype), min=1.0)
    return (HMCState(z_prop.q, z_prop.logp, z_prop.grad),
            NUTSInfo(accept_prob, diverged, depth, n_leapfrog))


def nuts_kernel(logprob_fn, step_size, inv_mass_diag, max_depth=10):
    """One NUTS transition of a chain batch for a per-point target, (dim,)
    -> (): `kernel(draws, state)`, equal to JAX's
    `jax.vmap(nuts_kernel(...))`. The tree's loops end on host syncs ("is
    any chain still going?"), which `torch.func.vmap` cannot carry, so this
    twin is the vmapped form itself: `nuts_transition` with the gradients
    vmapped (`pointwise_lp_grad`). It launches no kernel."""
    lp_grad = pointwise_lp_grad(logprob_fn)

    def kernel(draws, state):
        return nuts_transition(lp_grad, state, draws, step_size,
                               inv_mass_diag, max_depth)

    return kernel


def run_nuts(generator, logprob_fn, init_position, num_samples,
             num_warmup=500, step_size=0.1, max_depth=8, target_accept=0.8,
             inv_mass_diag=None, draws=None, device="cuda",
             batched_target=True):
    """Full NUTS run: warmup (adaptation, as run_hmc's) + sampling.

    `logprob_fn` maps (chains, dim) -> (chains,), or, with
    `batched_target=False`, one point (dim,) to a scalar (`nuts_kernel`);
    a target of the other form raises ValueError. `init_position` is
    (chains, dim) on `device`. `inv_mass_diag` seeds the diagonal inverse
    mass; with num_warmup=0 it and `step_size` are used as they are.
    Randomness comes from `generator`, or from the iterable `draws` of
    per-transition draws (see the module docstring). Returns NUTSResult
    with samples (num_samples, chains, dim).
    """
    device = entry_device(device)
    check_on(device, init_position)
    chains, dim = init_position.shape
    dtype = init_position.dtype
    if inv_mass_diag is None:
        inv_mass_diag = torch.ones(dim, dtype=dtype, device=device)
    next_draws = draw_source(draws, lambda: TransitionDraws(
        generator, chains, dim, dtype, device))
    lp_grad = (batched_lp_grad if batched_target
               else pointwise_lp_grad)(logprob_fn)
    state = hmc_init(lp_grad, init_position)
    check_batched(state, batched_target)

    def step(state, eps, inv_mass):
        return nuts_transition(lp_grad, state, next_draws(), eps, inv_mass,
                               max_depth)

    if num_warmup > 0:
        state, eps_final, inv_mass_diag = warmup(
            step, state, num_warmup, step_size, inv_mass_diag, target_accept)
    else:
        eps_final = torch.as_tensor(step_size, dtype=dtype, device=device)

    n_run = padded_length(num_samples)
    samples = torch.empty(num_samples, chains, dim, dtype=dtype,
                          device=device)
    log_probs = torch.empty(num_samples, chains, dtype=dtype, device=device)
    acc, dep, div = torch.zeros(3, dtype=dtype, device=device)
    for i in range(n_run):
        state, info = step(state, eps_final, inv_mass_diag)
        acc = acc + torch.mean(info.accept_prob)
        dep = dep + torch.mean(info.depth.to(dtype))
        div = div + torch.mean(info.diverged.to(dtype))
        if i < num_samples:
            samples[i] = state.position
            log_probs[i] = state.log_prob
    return NUTSResult(
        samples=samples,
        log_probs=log_probs,
        accept_rate=acc / n_run,
        step_size=eps_final,
        inv_mass_diag=inv_mass_diag,
        mean_depth=dep / n_run,
        divergence_rate=div / n_run,
        final_state=state,
    )
