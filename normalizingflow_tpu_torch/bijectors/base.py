"""Bijector protocol and composition.

Twin of normalizingflow_tpu/bijectors/base.py. A bijector is an `nn.Module`
that owns its parameters:

    y, log_det = bij.forward(x)     # x -> y,  per-sample log|dy/dx|
    x, log_det = bij.inverse(y)     # y -> x,  per-sample log|dx/dy|

Shapes: x is (batch, dim); log_det is (batch,).
"""

from __future__ import annotations

import torch
from torch import nn


class Bijector(nn.Module):
    """Abstract invertible transform."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError


class Chain(Bijector):
    """Composition applied left-to-right in `forward`; `inverse` runs the
    reversed stack. Log-determinants are summed in application order."""

    def __init__(self, bijectors):
        super().__init__()
        self.bijectors = nn.ModuleList(bijectors)

    def forward(self, x):
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            x, ld = b.forward(x)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, y):
        log_det = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        for b in reversed(self.bijectors):
            y, ld = b.inverse(y)
            log_det = log_det + ld
        return y, log_det


class Repeat(Chain):
    """`n` copies of one bijector with independent parameters: forward in
    order, inverse in reverse, as a Chain.

    The JAX twin stacks the per-layer params on a leading axis and runs
    them under lax.scan, so its params tree is one layer's tree with every
    leaf stacked; `params.from_jax` and `to_numpy` stack and unstack along
    that axis. Takes the n layers, all of one type.
    """

    def __init__(self, bijectors):
        bijectors = list(bijectors)
        if not bijectors or len({type(b) for b in bijectors}) != 1:
            raise ValueError("Repeat takes one or more layers of one type")
        super().__init__(bijectors)


class Invert(Bijector):
    """Swap forward and inverse of a bijector."""

    def __init__(self, bijector):
        super().__init__()
        self.bijector = bijector

    def forward(self, x):
        return self.bijector.inverse(x)

    def inverse(self, y):
        return self.bijector.forward(y)
