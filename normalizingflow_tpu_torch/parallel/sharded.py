"""Mesh-sharded training and sampling entry points.

Twin of normalizingflow_tpu/parallel/sharded.py. JAX only annotates
shardings there and XLA inserts the collectives. Here each collective is
written out, on a `Mesh` (parallel/mesh.py), and these are all of them:

  * training: one SUM all-reduce of the flat gradients (divided by the
    world size), the loss and the logged means;
  * HMC: the warmup's mean acceptance (dual averaging), the Welford
    window's batch mean and squared deviations, and `accept_rate`'s sum
    (`mcmc.hmc.run_hmc(mesh=...)`);
  * SMC: an all-gather of each stage's incremental weights and of the
    particles before resampling, a broadcast of the resampling offset, and
    the mutation's mean acceptance (`mcmc.smc.run_smc(mesh=...)`).

Each function takes the global batch, as JAX's do, and keeps this rank's
rows of it (`shard_batch`; the world size must divide it). Draws passed as
`draws=` are this rank's rows; with a `seed`, each rank draws from its own
generator seeded with seed + rank. JAX returns one global array sharded
over the mesh; here each rank returns its own rows, beside the global
statistics.
"""

from __future__ import annotations

import torch

from ..mcmc.hmc import run_hmc
from ..mcmc.smc import run_smc
from ..train.objectives import forward_kl_loss
from .mesh import shard_batch


def _generator(mesh, seed):
    if seed is None:
        return None
    return torch.Generator(device=mesh.device).manual_seed(seed + mesh.rank)


def make_sharded_train_step(flow, optimizer, mesh):
    """Data-parallel forward-KL step over `mesh`: returns step(x) -> (loss,
    aux), which updates `flow` in place through `optimizer` (the port's
    Adam or ClippedAdam over the flow's parameters).

    `x` is the global batch; each rank takes the forward KL of its rows,
    and one SUM all-reduce over a flat buffer of every gradient, the loss
    and the logged means, divided by the world size, gives the global
    means. The parameters start equal on every rank and stay so: every
    rank applies the same update."""

    def step(x):
        x = shard_batch(mesh, x)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = forward_kl_loss(flow, x)
        loss.backward()
        params = [p for p in flow.parameters() if p.grad is not None]
        names = list(aux)
        parts = [p.grad.reshape(-1) for p in params] + [
            loss.detach().reshape(1)] + [aux[k].detach().reshape(1)
                                         for k in names]
        flat = mesh.sum(torch.cat(parts)) / mesh.size
        sizes = [p.numel() for p in params] + [1] * (1 + len(names))
        reduced = flat.split(sizes)
        for p, g in zip(params, reduced):
            p.grad.copy_(g.view_as(p))
        optimizer.step()
        loss = reduced[len(params)][0]
        return loss, {k: reduced[len(params) + 1 + i][0]
                      for i, k in enumerate(names)}

    return step


def run_hmc_sharded(mesh, seed, logprob_fn, init_position, num_samples,
                    **hmc_kwargs):
    """`mcmc.run_hmc` with the chain axis sharded over `mesh`.

    The chains are independent except for the warmup's mean acceptance,
    its Welford mass window and `accept_rate`, which are reduced over
    every rank's chains. Returns this rank's HMCResult: samples
    (num_samples, chains / W, dim) and the global accept_rate, step_size
    and inv_mass_diag."""
    return run_hmc(_generator(mesh, seed), logprob_fn,
                   shard_batch(mesh, init_position), num_samples,
                   device=mesh.device, mesh=mesh, **hmc_kwargs)


def run_smc_sharded(mesh, seed, particles, proposal_logprob_fn,
                    target_logprob_fn, **smc_kwargs):
    """`mcmc.run_smc` with the particle axis sharded over `mesh`.

    The per-particle work (incremental weights, HMC mutations) stays on
    each rank; the tempering bisection, the log-evidence and systematic
    resampling run on every rank over the all-gathered weights, with the
    first rank's offset. Returns this rank's SMCResult: its particles
    (N / W, dim) and the global log_evidence, n_stages and
    final_accept."""
    return run_smc(_generator(mesh, seed), shard_batch(mesh, particles),
                   proposal_logprob_fn, target_logprob_fn,
                   device=mesh.device, mesh=mesh, **smc_kwargs)
