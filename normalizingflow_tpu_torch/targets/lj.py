"""Differentiable Lennard-Jones system with minimum-image PBC.
Twin of normalizingflow_tpu/targets/lj.py.

The energy of the whole batch is computed at once on (batch, N, N, 3)
separations: per-component minimum-image wrap, an optional cutoff with
energy shift, 4 eps ((s/r)^12 - (s/r)^6) pair energies, half of the double
sum. As in JAX:

  * the wrap is `diff - (|diff| > L/2) sign(diff) L`, exactly as written
    there (not a remainder, which rounds differently);
  * self pairs and pairs beyond the cutoff see r^2 = 1 *before* the divide
    and their energies are selected away with `where`, so `force`
    (autograd, targets/base.py) is free of NaN at excluded pairs.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .dataset import TrajectoryTarget


def lj_pair_energy_total(pos, boxlength, epsilon=1.0, sigma=1.0, cutoff=None,
                         shift=True):
    """Total LJ energy of each configuration: pos (..., n, d) -> (...)."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    if boxlength is not None:
        diff = diff - (torch.abs(diff) > 0.5 * boxlength) * torch.sign(
            diff) * boxlength
    r2 = torch.sum(diff * diff, dim=-1)
    n = pos.shape[-2]
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    if cutoff is not None:
        valid = valid & (r2 <= cutoff * cutoff)
    r2_safe = torch.where(valid, r2, torch.ones_like(r2))
    ratio = sigma * sigma / r2_safe
    inv_r6 = ratio * ratio * ratio
    pair = 4.0 * epsilon * (inv_r6 * inv_r6 - inv_r6)
    if cutoff is not None and shift:
        s6 = (sigma / cutoff) ** 6
        pair = pair - 4.0 * epsilon * (s6 * s6 - s6)
    pair = torch.where(valid, pair, torch.zeros_like(pair))
    return 0.5 * torch.sum(pair, dim=(-2, -1))


class LennardJones(TrajectoryTarget):
    """LJ solid target. potential(x): x (batch, n*d) or (batch, n, d) ->
    (batch,) total energies; log_prob = -U/kT. With trajectory data attached
    (`pos_dir` or `update_data`), `sample` draws frames from it."""

    def __init__(self, n_particles, boxlength, point_dim=3, epsilon=1.0,
                 sigma=1.0, cutoff=None, shift=True, kT=1.0, pos_dir=None,
                 data_type="xyz", device=None, dtype=None):
        super().__init__()
        self.n_particles = int(n_particles)
        self.point_dim = int(point_dim)
        self.dim = self.n_particles * self.point_dim
        self.boxlength = None if boxlength is None else float(boxlength)
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)
        self.cutoff = None if cutoff is None else float(cutoff)
        self.shift = bool(shift)
        self.kT = float(kT)
        self._attach(pos_dir, data_type, device, dtype)

    def potential(self, x):
        """The energy of each configuration, inside the span `lj.energy`
        (utils.profiling.annotate: free while no profiler runs)."""
        with annotate("lj.energy"):
            pos = x.reshape(-1, self.n_particles, self.point_dim)
            return lj_pair_energy_total(pos, self.boxlength, self.epsilon,
                                        self.sigma, self.cutoff, self.shift)

    def log_prob(self, x):
        return -self.potential(x) / self.kT
