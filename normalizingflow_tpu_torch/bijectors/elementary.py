"""Elementary bijectors. Twin of normalizingflow_tpu/bijectors/elementary.py
(only ActNorm so far)."""

from __future__ import annotations

import torch
from torch import nn

from .base import Bijector


class ActNorm(Bijector):
    """Per-dim affine z = x * exp(log_sigma) + mu, zero-initialised.

    log-det is sum(log_sigma), broadcast to (batch,).
    """

    def __init__(self, dim, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        kw = dict(device=device, dtype=dtype or torch.get_default_dtype())
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
