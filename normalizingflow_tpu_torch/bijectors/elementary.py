"""Elementary bijectors: Planar, Radial, ActNorm, invertible PLU linear.
Twin of normalizingflow_tpu/bijectors/elementary.py, with its fixes of the
original code (documented per class there and here)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .base import Bijector
from .rqs import softplus


def _uniform(shape, bound, generator, device, dtype):
    """uniform(-bound, bound), as the JAX twin's `_uniform`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (u * 2.0 - 1.0) * bound


def _dtype(dtype):
    return dtype or torch.get_default_dtype()


class Planar(Bijector):
    """Planar flow z = x + u_hat * h(w.x + b)  [Rezende & Mohamed 2015].

    tanh, leaky_relu or elu nonlinearities; under tanh, u is
    reparameterized as u + (softplus(w.u) - w.u - 1) * w / |w|^2, which
    guarantees invertibility. log-det = log(|1 + h'(w.x + b) w.u_hat| +
    1e-4), the original's floor. There is no algebraic inverse: `inverse`
    raises, as in JAX.
    """

    def __init__(self, dim, nonlinearity="tanh", generator=None,
                 device=None, dtype=None):
        super().__init__()
        if nonlinearity not in ("tanh", "leaky_relu", "elu"):
            raise NotImplementedError(
                f"Non-linearity {nonlinearity!r} is not supported.")
        self.dim = int(dim)
        self.nonlinearity = nonlinearity
        bound = math.sqrt(1.0 / self.dim)
        kw = dict(generator=generator, device=device, dtype=_dtype(dtype))
        self.w = nn.Parameter(_uniform((self.dim,), bound, **kw))
        self.u = nn.Parameter(_uniform((self.dim,), bound, **kw))
        self.b = nn.Parameter(_uniform((1,), bound, **kw))

    def _h(self, x):
        if self.nonlinearity == "tanh":
            return torch.tanh(x)
        if self.nonlinearity == "leaky_relu":
            return F.leaky_relu(x, negative_slope=0.01)
        return F.elu(x)

    def _h_prime(self, x):
        if self.nonlinearity == "tanh":
            return 1.0 - torch.tanh(x) ** 2
        if self.nonlinearity == "leaky_relu":
            return torch.where(x > 0, torch.ones_like(x),
                               torch.full_like(x, 0.01))
        return torch.where(x > 0, torch.ones_like(x), torch.exp(x))

    def forward(self, x):
        w, u = self.w, self.u
        if self.nonlinearity == "tanh":
            wu = w @ u
            scal = softplus(wu) - wu - 1.0
            u_hat = u + scal * w / torch.sum(w * w)
        else:
            u_hat = u
        lin = x @ w[:, None] + self.b  # (B, 1)
        z = x + u_hat * self._h(lin)
        phi = self._h_prime(lin) * w  # (B, dim)
        log_det = torch.log(torch.abs(1.0 + phi @ u_hat) + 1e-4)
        return z, log_det

    def inverse(self, y):
        raise NotImplementedError("Planar flow has no algebraic inverse.")


class Radial(Bijector):
    """Radial flow z = x + beta_hat * h(alpha, r) * (x - x0), with h =
    1 / (alpha + r), r = |x - x0| per sample, alpha = exp(log_alpha) and
    beta_hat = -alpha + softplus(beta) (invertible).

    The exact inverse of the JAX twin: |y - x0| = R gives r^2 + (alpha +
    beta_hat - R) r - alpha R = 0, whose positive root recovers x = x0 +
    (y - x0) / (1 + beta_hat / (alpha + r)).
    """

    def __init__(self, dim, generator=None, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        bound = math.sqrt(1.0 / self.dim)
        kw = dict(generator=generator, device=device, dtype=_dtype(dtype))
        self.x0 = nn.Parameter(_uniform((self.dim,), bound, **kw))
        self.log_alpha = nn.Parameter(_uniform((1,), bound, **kw))
        self.beta = nn.Parameter(_uniform((1,), bound, **kw))

    def _transformed(self):
        alpha = torch.exp(self.log_alpha[0])
        return alpha, -alpha + softplus(self.beta[0])

    @staticmethod
    def _log_det(alpha, beta, r, n):
        # d/dr [r * (1 + beta*h)] = 1 + beta*h - beta*r/(alpha+r)^2
        h = 1.0 / (alpha + r)
        return (n - 1) * torch.log(1.0 + beta * h) + torch.log(
            1.0 + beta * h - beta * r / (alpha + r) ** 2)

    def forward(self, x):
        alpha, beta = self._transformed()
        diff = x - self.x0
        r = torch.linalg.vector_norm(diff, dim=-1)  # (B,)
        h = 1.0 / (alpha + r)
        z = x + (beta * h)[:, None] * diff
        return z, self._log_det(alpha, beta, r, x.shape[-1])

    def inverse(self, y):
        alpha, beta = self._transformed()
        diff = y - self.x0
        big_r = torch.linalg.vector_norm(diff, dim=-1)
        bq = alpha + beta - big_r
        r = 0.5 * (-bq + torch.sqrt(bq * bq + 4.0 * alpha * big_r))
        scale = 1.0 / (1.0 + beta / (alpha + r))
        x = self.x0 + scale[:, None] * diff
        return x, -self._log_det(alpha, beta, r, y.shape[-1])


class ActNorm(Bijector):
    """Per-dim affine z = x * exp(log_sigma) + mu, zero-initialised.

    log-det is sum(log_sigma), broadcast to (batch,).
    """

    def __init__(self, dim, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        kw = dict(device=device, dtype=_dtype(dtype))
        self.mu = nn.Parameter(torch.zeros(self.dim, **kw))
        self.log_sigma = nn.Parameter(torch.zeros(self.dim, **kw))

    def forward(self, x):
        z = x * torch.exp(self.log_sigma) + self.mu
        ld = torch.sum(self.log_sigma)
        return z, ld.expand(x.shape[0]).to(x.dtype)

    def inverse(self, y):
        x = (y - self.mu) * torch.exp(-self.log_sigma)
        ld = -torch.sum(self.log_sigma)
        return x, ld.expand(y.shape[0]).to(y.dtype)


class InvertibleLinear(Bijector):
    """Invertible dense mixing, W = P @ L @ (U + diag(S)) ("1x1
    convolution"): P a fixed permutation from the LU of a random rotation,
    L unit lower triangular and U strictly upper triangular, both learned,
    S the learned diagonal. z = x @ W, log-det = sum(log|S|).

    P is a parameter that takes no gradient (JAX: stop_gradient), so the
    params tree keeps JAX's four leaves. The inverse solves two triangular
    systems against the current parameters: no cached inverse, so no stale
    one after an update (the original's bug, fixed in JAX).
    """

    def __init__(self, dim, generator=None, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        dtype = _dtype(dtype)
        a = torch.randn(self.dim, self.dim, generator=generator,
                        device=device, dtype=dtype)
        w, _ = torch.linalg.qr(a)
        p, l, u = torch.linalg.lu(w)
        self.P = nn.Parameter(p, requires_grad=False)
        self.L = nn.Parameter(l)
        self.S = nn.Parameter(torch.diagonal(u).clone())
        self.U = nn.Parameter(torch.triu(u, diagonal=1))

    def _lu(self):
        eye = torch.eye(self.dim, dtype=self.L.dtype, device=self.L.device)
        lower = torch.tril(self.L, diagonal=-1) + eye
        upper = torch.triu(self.U, diagonal=1) + torch.diag(self.S)
        return self.P.detach(), lower, upper

    def _log_det(self, x):
        ld = torch.sum(torch.log(torch.abs(self.S)))
        return ld.expand(x.shape[0]).to(x.dtype)

    def forward(self, x):
        p, lower, upper = self._lu()
        return x @ p @ lower @ upper, self._log_det(x)

    def inverse(self, y):
        p, lower, upper = self._lu()
        # x = y U^-1 L^-1 P^T, by two triangular solves from the right
        a = torch.linalg.solve_triangular(upper, y, upper=True, left=False)
        b = torch.linalg.solve_triangular(lower, a, upper=False, left=False)
        return b @ p.T, -self._log_det(y)
