"""Coupling-layer bijectors: affine (RealNVP) and rational-quadratic spline.
Twin of normalizingflow_tpu/bijectors/coupling.py."""

from __future__ import annotations

import torch

from .base import Bijector
from .mlp import MLP
from .rqs import apply_rqs, softplus, split_spline_params


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


class SplineCoupling(Bijector):
    """RQS coupling layer over particle coordinates ("NSF_CL").

    The flattened (batch, size * space_dim) input is viewed as
    (batch, size, space_dim). The coordinate axes in `mask` condition the
    others: one MLP `psi` maps the masked coordinates to the 3K-1 spline
    parameters of each transformed scalar, which go through a monotone RQS
    with tail bound B. As in the JAX twin, the layer applies softmax * 2B
    to widths and heights and softplus to derivatives, and the spline
    normalizes again (the reference's double normalization, kept). Each
    block goes back to its own coordinate positions, so the layer is a
    bijection for every mask, prefix or not.
    """

    def __init__(self, size, space_dim=3, num_bins=32, tail_bound=3.0,
                 hidden_dim=800, mask=(0,), generator=None, device=None,
                 dtype=None):
        super().__init__()
        self.size = int(size)
        self.space_dim = int(space_dim)
        self.num_bins = int(num_bins)
        self.tail_bound = float(tail_bound)
        self.hidden_dim = int(hidden_dim)
        self.mask = tuple(int(m) for m in mask)
        self.unmasked = tuple(a for a in range(self.space_dim)
                              if a not in self.mask)
        self.n_cond = self.size * len(self.mask)
        self.n_trans = self.size * len(self.unmasked)
        out = (3 * self.num_bins - 1) * self.n_trans
        self.psi = MLP(self.n_cond, out, self.hidden_dim, generator=generator,
                       device=device, dtype=dtype)

    def spline_params(self, cond):
        """(batch, n_cond) -> w, h (batch, n_trans, K), d (..., K-1)."""
        k = self.num_bins
        raw = self.psi(cond).reshape(cond.shape[0], self.n_trans, 3 * k - 1)
        w, h, d = split_spline_params(raw, k)
        w = 2.0 * self.tail_bound * torch.softmax(w, dim=-1)
        h = 2.0 * self.tail_bound * torch.softmax(h, dim=-1)
        return w, h, softplus(d)

    def split(self, x):
        x = x.reshape(-1, self.size, self.space_dim)
        cond = x[:, :, list(self.mask)].reshape(x.shape[0], -1)
        trans = x[:, :, list(self.unmasked)].reshape(x.shape[0], -1)
        return cond, trans

    def join(self, cond, trans):
        b = cond.shape[0]
        cond = cond.reshape(b, self.size, len(self.mask))
        trans = trans.reshape(b, self.size, len(self.unmasked))
        cols = [cond[:, :, self.mask.index(a)] if a in self.mask
                else trans[:, :, self.unmasked.index(a)]
                for a in range(self.space_dim)]
        return torch.stack(cols, dim=-1).reshape(b, -1)

    def _apply(self, x, inverse):
        cond, trans = self.split(x)
        w, h, d = self.spline_params(cond)
        out, ld = apply_rqs(trans, w, h, d, inverse=inverse,
                            tail_bound=self.tail_bound)
        return self.join(cond, out), torch.sum(ld, dim=1)

    def forward(self, x):
        return self._apply(x, inverse=False)

    def inverse(self, y):
        return self._apply(y, inverse=True)
