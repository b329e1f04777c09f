"""Coupling-layer bijectors. Twin of normalizingflow_tpu/bijectors/coupling.py
(AffineCoupling so far; SplineCoupling comes with the RQS kernel)."""

from __future__ import annotations

import torch

from .base import Bijector
from .mlp import MLP


class AffineCoupling(Bijector):
    """RealNVP double affine coupling layer.

    Split x into (lower, upper) halves; the lower half conditions an affine
    map of the upper half (upper' = t1(lower) + upper * exp(s1(lower))),
    then the new upper half conditions the lower half. log-det =
    sum(s1) + sum(s2). Four independent tanh MLPs t1, s1, t2, s2.

    `s_cap` soft-clamps the log-scale, s -> s_cap * tanh(s / s_cap);
    `zero_init` zeroes every conditioner's output layer so the layer starts
    as the identity. Both default off (reference-exact).
    """

    def __init__(self, dim, hidden_dim=800, s_cap=None, zero_init=False,
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.half = self.dim // 2
        self.hidden_dim = int(hidden_dim)
        self.s_cap = None if s_cap is None else float(s_cap)
        self.zero_init = bool(zero_init)
        h, other = self.half, self.dim - self.half
        kw = dict(zero_last=self.zero_init, generator=generator,
                  device=device, dtype=dtype)
        self.t1 = MLP(h, other, self.hidden_dim, **kw)
        self.s1 = MLP(h, other, self.hidden_dim, **kw)
        self.t2 = MLP(other, h, self.hidden_dim, **kw)
        self.s2 = MLP(other, h, self.hidden_dim, **kw)

    def _s(self, raw):
        if self.s_cap is None:
            return raw
        return self.s_cap * torch.tanh(raw / self.s_cap)

    def forward(self, x):
        lower, upper = x[:, : self.half], x[:, self.half :]
        t1 = self.t1(lower)
        s1 = self._s(self.s1(lower))
        upper = t1 + upper * torch.exp(s1)
        t2 = self.t2(upper)
        s2 = self._s(self.s2(upper))
        lower = t2 + lower * torch.exp(s2)
        z = torch.cat([lower, upper], dim=1)
        return z, torch.sum(s1, dim=1) + torch.sum(s2, dim=1)

    def inverse(self, z):
        lower, upper = z[:, : self.half], z[:, self.half :]
        t2 = self.t2(upper)
        s2 = self._s(self.s2(upper))
        lower = (lower - t2) * torch.exp(-s2)
        t1 = self.t1(lower)
        s1 = self._s(self.s1(lower))
        upper = (upper - t1) * torch.exp(-s1)
        x = torch.cat([lower, upper], dim=1)
        return x, -torch.sum(s1, dim=1) - torch.sum(s2, dim=1)
