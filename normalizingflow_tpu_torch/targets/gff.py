"""Massive Gaussian free field on a periodic 2-D lattice.
Twin of normalizingflow_tpu/targets/gff.py.

The surrogate of the reference's polymer field data: a multi-channel
massive GFF, exactly sampleable and with an exactly normalized density.
Action per channel c, periodic boundary conditions:

    S_c[w] = 1/2 sum_x [ sum_mu (w(x+mu) - w(x))^2 + m_c^2 w(x)^2 ]

The precision operator is diagonal in the Fourier basis, with eigenvalues
lambda_c(k) = 4 sin^2(pi k1/L) + 4 sin^2(pi k2/L) + m_c^2, which gives
exact sampling (white noise coloured by 1/sqrt(lambda) in k-space) and the
normalizer log Z_c = -1/2 sum_k log(lambda_c(k) / 2 pi).

`log_prob` and `potential` are local quadratic forms (rolls). `sample`
runs torch.fft on the target's own device; the JAX package pins its FFT to
the host CPU because the TPU backend lacks one. The two draw different
numbers, so the samples agree with JAX's in law, not draw for draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Target


def gff_action(w, mass):
    """Action of each (..., L, L) field at scalar mass (periodic BCs)."""
    grad2 = ((torch.roll(w, -1, dims=-2) - w) ** 2
             + (torch.roll(w, -1, dims=-1) - w) ** 2)
    return 0.5 * torch.sum(grad2 + (mass * mass) * w * w, dim=(-2, -1))


class GaussianField(Target):
    """Multi-channel massive GFF; x is (batch, channels*L*L) flattened.

    Exact `sample` and an exactly normalized `log_prob`. The eigenvalues
    are a buffer in the target's dtype on its device; `log_norm` is a
    Python float computed in float64 on the host."""

    def __init__(self, L=32, channels=2, mass=(0.5, 1.0), device=None,
                 dtype=None):
        super().__init__()
        self.L = int(L)
        self.channels = int(channels)
        if isinstance(mass, (int, float)):
            mass = [float(mass)] * self.channels
        if len(mass) != self.channels:
            raise ValueError(f"need {self.channels} masses, got {len(mass)}")
        self.mass = tuple(float(m) for m in mass)
        self.dim = self.channels * self.L * self.L

        k = np.arange(self.L)
        s2 = 4.0 * np.sin(np.pi * k / self.L) ** 2
        lap = s2[:, None] + s2[None, :]  # (L, L) lattice Laplacian spectrum
        eig = np.stack([lap + m * m for m in self.mass])  # (channels, L, L)
        # log p = -S + 1/2 sum_k log lambda_k - (dim/2) log 2pi
        self.log_norm = float(0.5 * np.sum(np.log(eig))
                              - 0.5 * self.dim * math.log(2.0 * math.pi))
        self.register_buffer("eigenvalues", torch.as_tensor(
            eig, dtype=dtype or torch.get_default_dtype(), device=device))

    def _fields(self, x):
        return x.reshape(-1, self.channels, self.L, self.L)

    def potential(self, x):
        w = self._fields(x)
        return sum(gff_action(w[:, c], self.mass[c])
                   for c in range(self.channels))

    def log_prob(self, x):
        return -self.potential(x) + self.log_norm

    def sample(self, nsamples, generator=None, flatten=True):
        """`nsamples` exact draws: standard normals from `generator` on the
        target's device, coloured in k-space by 1/sqrt(lambda)."""
        eig = self.eigenvalues
        xi = torch.randn((int(nsamples), self.channels, self.L, self.L),
                         generator=generator, device=eig.device,
                         dtype=eig.dtype)
        spectrum = torch.fft.fft2(xi, norm="ortho")
        w = torch.fft.ifft2(spectrum / torch.sqrt(eig), norm="ortho").real
        return w.reshape(int(nsamples), -1) if flatten else w
