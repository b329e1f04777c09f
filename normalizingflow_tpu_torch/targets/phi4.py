"""Lattice phi^4 scalar field theory target.
Twin of normalizingflow_tpu/targets/phi4.py.

The 2-D Euclidean action with periodic boundary conditions,

    S[phi] = sum_x [ -2 kappa * phi_x * sum_mu phi_{x+mu}
                     + (1 - 2 lambda) phi_x^2 + lambda phi_x^4 ],

written as shifted-array sums over a whole batch of fields at once.
"""

from __future__ import annotations

import torch

from .dataset import TrajectoryTarget


def phi4_action(phi, kappa, lam):
    """Action of each (..., L, L) field configuration."""
    neighbors = torch.roll(phi, 1, dims=-2) + torch.roll(phi, 1, dims=-1)
    phi2 = phi * phi
    return torch.sum(
        -2.0 * kappa * phi * neighbors + (1.0 - 2.0 * lam) * phi2
        + lam * phi2 * phi2, dim=(-2, -1))


class Phi4Lattice(TrajectoryTarget):
    """2-D phi^4 lattice; log_prob = -S[phi]. x is (batch, L*L) flattened.

    Like LennardJones and EAMIron, an HMC trajectory can be attached
    (`pos_dir` or `update_data`), so the target doubles as the training
    CLI's data source."""

    def __init__(self, L=8, kappa=0.3, lam=0.022, pos_dir=None,
                 data_type="npy", device=None, dtype=None):
        super().__init__()
        self.L = int(L)
        self.dim = self.L * self.L
        self.kappa = float(kappa)
        self.lam = float(lam)
        self._attach(pos_dir, data_type, device, dtype)

    def potential(self, x):
        return phi4_action(x.reshape(-1, self.L, self.L), self.kappa,
                           self.lam)

    def log_prob(self, x):
        return -self.potential(x)

    def magnetization(self, x):
        """Mean field value per configuration (the order parameter)."""
        return torch.mean(x.reshape(-1, self.dim), dim=-1)
