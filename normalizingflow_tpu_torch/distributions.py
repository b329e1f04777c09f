"""Base distributions (flow priors). Twin of normalizingflow_tpu/distributions.py
(DiagNormal so far)."""

from __future__ import annotations

import math

import torch
from torch import nn


def _gaussian_log_prob(dev, var):
    """Sum of independent N(0, var) log-densities over the last axis."""
    d = dev.shape[-1]
    return -0.5 * torch.sum(dev * dev, dim=-1) / var - 0.5 * d * (
        math.log(2.0 * math.pi) + math.log(var)
    )


class DiagNormal(nn.Module):
    """Isotropic normal N(mean, var * I) over `dim` flattened coordinates.

    `mean` is a buffer, so `.to(device, dtype)` moves it with the flow and
    `sample` draws on its device and in its dtype.
    """

    def __init__(self, dim, mean=0.0, var=1.0, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.var = float(var)
        self.register_buffer("mean", torch.as_tensor(
            mean, dtype=dtype or torch.get_default_dtype(), device=device))

    def sample(self, n, generator=None):
        eps = torch.randn(n, self.dim, generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + math.sqrt(self.var) * eps

    def log_prob(self, x):
        return _gaussian_log_prob(x - self.mean, self.var)
