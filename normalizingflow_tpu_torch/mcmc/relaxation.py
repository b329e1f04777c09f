"""Flow-seeded relaxation and hybrid training-data collection.
Twin of normalizingflow_tpu/mcmc/relaxation.py.

Every frame relaxes in one batch: each gradient is one autograd pass over
the batch's summed log-density (`hmc.batched_lp_grad`), where JAX vmaps a
per-frame gradient; the arithmetic is the same. The raw draws (standard
normals of the momenta, uniforms of the Metropolis filter) come from a
`torch.Generator` or are passed in, so a call can be held against the JAX
package's own numbers.

The relaxation kernel is a damped leapfrog whose per-step displacement is
capped at `max_disp` (the LAMMPS `fix nve/limit` mechanism): a flow sample
with overlapping particles has |grad U| around 1e9, and the cap keeps such
a frame finite. Both ensembles of `apps.fe_eval.fe_diff` go through the
same kernel, so the cap does not bias the free-energy difference.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from .hmc import batched_lp_grad, run_hmc


def _wrap(x, box):
    """Minimum-image wrap into [-box/2, box/2] (round half to even, as
    jnp.round)."""
    return x - torch.round(x / box) * box


def _energy_lp_grad(target, beta):
    return batched_lp_grad(lambda x: -target.potential(x) * beta)


def _damped_path(lp_grad, q, p, path_len, step_size, max_disp, damping):
    """`path_len` damped, displacement-capped leapfrog steps from (q, p):
    p <- damping (p + eps/2 g); q <- q + clip(eps p, +-max_disp);
    g <- grad(q); p <- damping (p + eps/2 g). Returns the final q (the
    last step's gradient and closing kick do not move it and are skipped).
    """
    _, g = lp_grad(q)
    for i in range(path_len):
        if i:
            _, g = lp_grad(q)
            p = damping * (p + 0.5 * step_size * g)
        p = damping * (p + 0.5 * step_size * g)
        q = q + torch.clamp(step_size * p, -max_disp, max_disp)
    return q


class RelaxationResult(NamedTuple):
    positions: torch.Tensor        # (n, dim) relaxed frames
    q_learned: torch.Tensor        # (n,) flow logp, velocity marginalized
    q_energy: torch.Tensor         # (n,) -U/kT after relaxation
    q_energy_before: torch.Tensor  # (n,) -U/kT before


def relaxation_step(flow, target, traj, kT=1.0, path_len=12, step_size=1e-3,
                    soft_factor=1000.0, max_disp=0.05, damping=0.5,
                    generator=None, draws=None):
    """Short relaxation of each frame at a softened temperature: momenta of
    variance soft_factor/beta, one capped damped trajectory, energies
    before and after, and the flow log-density of the relaxed frame with
    the momentum marginalized out (`integrate_out_v`).

    `draws` = (standard normals (n, dim) of the momenta, standard normals
    (npoints, n, dim) of integrate_out_v's momenta); else from `generator`.
    """
    n, dim = traj.shape
    beta = 1.0 / kT
    if draws is None:
        draws = (torch.randn(n, dim, generator=generator, dtype=traj.dtype,
                             device=traj.device), None)
    normal, normal_v = draws
    with torch.no_grad():
        q_before = -target.potential(traj) * beta
    p0 = normal * math.sqrt(soft_factor / beta if beta > 0 else 1.0)
    relaxed = _damped_path(_energy_lp_grad(target, beta), traj, p0,
                           path_len, step_size, max_disp, damping)
    box = getattr(target, "boxlength", None)
    if box:
        relaxed = _wrap(relaxed, box)
    with torch.no_grad():
        q_after = -target.potential(relaxed) * beta
    q_learned = integrate_out_v(
        flow, target, relaxed, kT=kT, path_len=path_len, step_size=step_size,
        soft_factor=soft_factor, max_disp=max_disp, damping=damping,
        generator=generator, normal=normal_v)
    return RelaxationResult(relaxed, q_learned, q_after, q_before)


def integrate_out_v(flow, target, frames, kT=1.0, npoints=10, path_len=12,
                    step_size=1e-3, soft_factor=1000.0, max_disp=0.05,
                    damping=0.5, generator=None, normal=None):
    """log p(frame) ~ logsumexp_v log p_flow(endpoint(frame, v)) - log
    npoints, over `npoints` momenta per frame drawn from the relaxation's
    own softened law (variance soft_factor/beta).

    All npoints x n trajectories run as one batch, and their endpoints go
    through ONE flat `flow.log_prob` call of npoints * n rows. `normal`:
    the momenta's standard normals (npoints, n, dim); else from
    `generator`."""
    n, dim = frames.shape
    beta = 1.0 / kT
    if normal is None:
        normal = torch.randn(npoints, n, dim, generator=generator,
                             dtype=frames.dtype, device=frames.device)
    npoints = normal.shape[0]
    ps = normal * math.sqrt(soft_factor / beta)
    starts = frames.expand(npoints, n, dim).reshape(npoints * n, dim)
    ends = _damped_path(_energy_lp_grad(target, beta), starts,
                        ps.reshape(npoints * n, dim), path_len, step_size,
                        max_disp, damping)
    box = getattr(target, "boxlength", None)
    if box:
        ends = _wrap(ends, box)
    with torch.no_grad():
        lps = flow.log_prob(ends).reshape(npoints, n)
    return torch.logsumexp(lps, dim=0) - math.log(npoints)


def metropolize(target, x, kT=1.0, burnin=20, generator=None, u=None):
    """Independence-Metropolis filter of flow samples by target energy:
    walk the samples in order and move to sample i with probability
    exp(-(U_i - U_cur)/kT). Returns (mask of moves after `burnin`,
    energies/kT). Sequential, on the host; `u`: the (n,) uniforms, else
    from `generator`."""
    with torch.no_grad():
        energies = target.potential(x) / kT
    n = x.shape[0]
    if u is None:
        u = torch.rand(n, generator=generator, dtype=energies.dtype,
                       device=energies.device)
    log_u, e = torch.log(u).cpu(), energies.cpu()
    accepts = torch.zeros(n, dtype=torch.bool)
    cur = e[0]
    for i in range(n):
        if bool(log_u[i] < cur - e[i]):
            accepts[i] = True
            cur = e[i]
    mask = accepts & (torch.arange(n) > burnin)
    return mask.to(energies.device), energies


def collect_hmc_data(flow, target, n_chains=8, n_steps=500, burnin=100,
                     step_size=0.01, num_leapfrog=10, kT=1.0,
                     output_dir=None, n_particles=None, generator=None,
                     z=None, draws=None, device="cuda"):
    """Flow samples -> HMC on the target (no warmup) -> the burn-in-trimmed
    chains as training data, wrapped into the box. Returns (data
    (n_frames, dim), acceptance rate).

    The flow's latents are `z` or drawn from `generator`; the HMC draws are
    `draws` (see mcmc.hmc) or drawn from `generator`. With `output_dir`,
    writes generated_configs.xyz (the flow seeds) and relaxed_configs.xyz
    (the trimmed chains) for 3-D particle systems."""
    with torch.no_grad():
        x0, _, _ = flow.sample(n_chains, generator=generator, z=z)

    def logprob(x):
        lp = target.log_prob(x)
        return lp / kT if kT != 1.0 else lp

    res = run_hmc(generator, logprob, x0, num_samples=n_steps, num_warmup=0,
                  step_size=step_size, num_leapfrog=num_leapfrog,
                  draws=draws, device=device)
    dim = x0.shape[1]
    data = res.samples[burnin:].reshape(-1, dim)
    box = getattr(target, "boxlength", None)
    if box:
        data = _wrap(data, box)
    npart = n_particles if n_particles is not None else dim // 3
    if output_dir is not None and npart * 3 == dim:
        from ..io.xyz import write_xyz

        os.makedirs(output_dir, exist_ok=True)
        write_xyz(os.path.join(output_dir, "generated_configs.xyz"),
                  x0.cpu().numpy(), npart)
        write_xyz(os.path.join(output_dir, "relaxed_configs.xyz"),
                  data.cpu().numpy(), npart)
    return data, res.accept_rate
