"""Target-density protocol. Twin of normalizingflow_tpu/targets/base.py.

  log_prob(x)  : (batch, dim) -> (batch,)   unnormalized log-density
  potential(x) : -log_prob
  force(x)     : -grad potential, by autograd
"""

from __future__ import annotations

import torch
from torch import nn


class Target(nn.Module):
    """Base class; subclasses define log_prob and/or potential."""

    dim: int

    def log_prob(self, x):
        return -self.potential(x)

    def potential(self, x):
        return -self.log_prob(x)

    def force(self, x):
        """-dU/dx, batched: x (batch, dim) -> (batch, dim)."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.potential(x).sum(), x)
        return -g


class PotentialTarget(Target):
    """Wrap a batched energy function U(x) -> (batch,) as a Target with
    log_prob = -beta * U."""

    def __init__(self, energy_fn, dim, beta=1.0):
        super().__init__()
        self.energy_fn = energy_fn
        self.dim = int(dim)
        self.beta = float(beta)

    def potential(self, x):
        return self.energy_fn(x)

    def log_prob(self, x):
        return -self.beta * self.potential(x)
