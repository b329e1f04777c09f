"""Analytic benchmark targets. Twin of normalizingflow_tpu/targets/analytic.py.

Constant arrays are built in float64 and stored as buffers in the default
dtype; `.to(device, dtype)` moves them with the module.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Target


class IllConditionedGaussian(Target):
    """N(0, diag(sigma^2)), stddevs condition**linspace(-0.5, 0.5, dim)
    permuted by `perm`.

    The JAX twin draws `perm` with threefry from a seed; torch cannot
    reproduce that stream, so the port takes the permutation itself (pass
    the JAX one to compare the two).
    """

    def __init__(self, dim, perm, condition=1e4, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.condition = float(condition)
        perm = np.asarray(perm)
        if sorted(perm.tolist()) != list(range(self.dim)):
            raise ValueError("perm must be a permutation of range(dim)")
        sigmas = self.condition ** np.linspace(-0.5, 0.5, self.dim)
        self.register_buffer("sigmas", torch.as_tensor(
            sigmas[perm], dtype=dtype or torch.get_default_dtype(),
            device=device))

    def log_prob(self, x):
        z = x / self.sigmas
        return -0.5 * torch.sum(z * z, dim=-1) \
            - torch.sum(torch.log(self.sigmas)) \
            - 0.5 * self.dim * math.log(2 * math.pi)

    def sample(self, n, generator=None):
        return torch.randn(n, self.dim, generator=generator,
                           device=self.sigmas.device,
                           dtype=self.sigmas.dtype) * self.sigmas

    @property
    def variances(self):
        return self.sigmas**2


class Banana(Target):
    """Rosenbrock-warped Gaussian in the first two dims, standard normal rest.

    x0 ~ N(0, s0^2); x1 | x0 ~ N(b*(x0^2 - s0^2), 1); x_i ~ N(0,1) for i>=2.
    """

    def __init__(self, dim=2, b=0.1, s0=3.0):
        super().__init__()
        if dim < 2:
            raise ValueError("Banana needs dim >= 2")
        self.dim = int(dim)
        self.b = float(b)
        self.s0 = float(s0)

    def log_prob(self, x):
        x0, x1, rest = x[..., 0], x[..., 1], x[..., 2:]
        lp = -0.5 * (x0 / self.s0) ** 2 - math.log(self.s0)
        mu1 = self.b * (x0 * x0 - self.s0 * self.s0)
        lp = lp - 0.5 * (x1 - mu1) ** 2
        lp = lp - 0.5 * torch.sum(rest * rest, dim=-1)
        return lp - 0.5 * self.dim * math.log(2 * math.pi)

    def sample(self, n, generator=None, device=None,
               dtype=torch.float32):
        kw = dict(generator=generator, device=device, dtype=dtype)
        x0 = torch.randn(n, **kw) * self.s0
        x1 = self.b * (x0**2 - self.s0**2) + torch.randn(n, **kw)
        rest = torch.randn(n, self.dim - 2, **kw)
        return torch.cat([x0[:, None], x1[:, None], rest], dim=1)


class NealsFunnel(Target):
    """v ~ N(0, 3^2); x_i | v ~ N(0, e^v), i = 1..dim-1."""

    def __init__(self, dim=10):
        super().__init__()
        self.dim = int(dim)

    def log_prob(self, x):
        v, rest = x[..., 0], x[..., 1:]
        lp_v = -0.5 * (v / 3.0) ** 2 - math.log(3.0)
        lp_rest = -0.5 * torch.sum(rest * rest, dim=-1) * torch.exp(-v) \
            - 0.5 * (self.dim - 1) * v
        return lp_v + lp_rest - 0.5 * self.dim * math.log(2 * math.pi)

    def sample(self, n, generator=None, device=None,
               dtype=torch.float32):
        kw = dict(generator=generator, device=device, dtype=dtype)
        v = 3.0 * torch.randn(n, **kw)
        rest = torch.randn(n, self.dim - 1, **kw) * torch.exp(v / 2)[:, None]
        return torch.cat([v[:, None], rest], dim=1)


class CorrelatedGaussian(Target):
    """Zero-mean Gaussian with AR(1)-style covariance rho^|i-j|."""

    def __init__(self, dim=32, rho=0.9, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.rho = float(rho)
        idx = torch.arange(self.dim, dtype=torch.float64)
        cov = self.rho ** torch.abs(idx[:, None] - idx[None, :])
        kw = dict(dtype=dtype or torch.get_default_dtype(), device=device)
        self.register_buffer("cov", cov.to(**kw))
        self.register_buffer("chol", torch.linalg.cholesky(cov).to(**kw))
        self.register_buffer("prec", torch.linalg.inv(cov).to(**kw))
        _, logdet = torch.linalg.slogdet(cov)
        self._log_norm = 0.5 * (self.dim * math.log(2 * math.pi)
                                + float(logdet))

    def log_prob(self, x):
        return -0.5 * torch.einsum("...i,ij,...j->...", x, self.prec, x) \
            - self._log_norm

    def sample(self, n, generator=None):
        eps = torch.randn(n, self.dim, generator=generator,
                          device=self.chol.device, dtype=self.chol.dtype)
        return eps @ self.chol.T
