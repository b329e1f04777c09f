"""Base distributions (flow priors, also usable as targets).
Twin of normalizingflow_tpu/distributions.py:

  * DiagNormal      -- isotropic normal;
  * GaussianMixture -- i.i.d. points, each a uniform mixture of isotropic
                       Gaussians, log_prob by logsumexp;
  * EinsteinCrystal -- Gaussian wells of stiffness alpha around lattice
                       sites, with an optional minimum-image wrap.

Each keeps its fixed arrays as buffers (so `.to(device)` moves them and
`sample` draws on their device and dtype) and draws from an explicit
`torch.Generator`. `sample(n)` is (n, dim_total), flattened.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .targets.base import Target


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


class GaussianMixture(Target):
    """`npoints` i.i.d. points, each a uniform mixture of isotropic
    Gaussians. centers (ncenters, point_dim); vars a scalar or (ncenters,).
    """

    def __init__(self, centers, vars, npoints=None, point_dim=3, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or torch.get_default_dtype()
        self.point_dim = int(point_dim)
        centers = torch.as_tensor(centers, dtype=dtype, device=device)
        self.register_buffer("centers", centers.reshape(-1, self.point_dim))
        self.ncenters = self.centers.shape[0]
        v = torch.as_tensor(vars, dtype=dtype, device=device).reshape(-1)
        self.register_buffer("vars", v.expand(self.ncenters).clone())
        self.npoints = (int(npoints) if npoints is not None
                        else self.ncenters)
        self.dim = self.npoints * self.point_dim

    def sample(self, n, generator=None):
        kw = dict(generator=generator, device=self.centers.device)
        comp = torch.randint(0, self.ncenters, (n, self.npoints), **kw)
        eps = torch.randn(n, self.npoints, self.point_dim,
                          dtype=self.centers.dtype, **kw)
        mu = self.centers[comp]
        sd = torch.sqrt(self.vars)[comp][..., None]
        return (mu + sd * eps).reshape(n, -1)

    def log_prob(self, x):
        pts = x.reshape(-1, self.npoints, self.point_dim)
        dev = pts[:, :, None, :] - self.centers[None, None, :, :]
        comp_lp = (-0.5 * torch.sum(dev * dev, dim=-1) / self.vars
                   - 0.5 * self.point_dim * (math.log(2 * math.pi)
                                             + torch.log(self.vars)))
        point_lp = torch.logsumexp(comp_lp, dim=-1) - math.log(self.ncenters)
        return torch.sum(point_lp, dim=-1)


class EinsteinCrystal(Target):
    """Gaussian wells of stiffness `alpha` around the lattice `centers`
    (natoms, point_dim): noise variance 1/alpha per coordinate, and with
    `boxlength` the periodic minimum-image wrap."""

    def __init__(self, centers, alpha=50.0, boxlength=None, point_dim=3,
                 device=None, dtype=None):
        super().__init__()
        dtype = dtype or torch.get_default_dtype()
        self.point_dim = int(point_dim)
        centers = torch.as_tensor(centers, dtype=dtype, device=device)
        self.register_buffer("centers", centers.reshape(-1, self.point_dim))
        self.natoms = self.centers.shape[0]
        self.alpha = float(alpha)
        self.boxlength = None if boxlength is None else float(boxlength)
        self.dim = self.natoms * self.point_dim

    def _wrap(self, x):
        if self.boxlength is None:
            return x
        length = self.boxlength
        return x - (torch.abs(x) > 0.5 * length) * torch.sign(x) * length

    def sample(self, n, generator=None):
        eps = torch.randn(n, self.natoms, self.point_dim, generator=generator,
                          device=self.centers.device,
                          dtype=self.centers.dtype)
        samples = self.centers + eps / math.sqrt(self.alpha)
        return self._wrap(samples).reshape(n, -1)

    def log_prob(self, x):
        dev = x.reshape(-1, self.natoms, self.point_dim) - self.centers
        per_atom = _gaussian_log_prob(self._wrap(dev), 1.0 / self.alpha)
        return torch.sum(per_atom, dim=-1)
