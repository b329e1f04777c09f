"""Conditioner MLP: 3 linear layers with tanh activations.

Twin of normalizingflow_tpu/bijectors/mlp.py. Weights keep the JAX layout,
(fan_in, fan_out) applied as `x @ w + b`, so a JAX params dict loads leaf
for leaf (params.from_jax) with no transposes.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _linear_init(fan_in, fan_out, generator, device, dtype):
    """torch.nn.Linear's default uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    kw = dict(generator=generator, device=device, dtype=dtype)
    w = (torch.rand(fan_in, fan_out, **kw) * 2.0 - 1.0) * bound
    b = (torch.rand(fan_out, **kw) * 2.0 - 1.0) * bound
    return w, b


def mlp_init(in_dim, out_dim, hidden_dim, zero_last=False, generator=None,
             device=None, dtype=None):
    """The JAX twin's leaf dict {w1, b1, w2, b2, w3, b3}, drawn layer by
    layer from `generator`. `zero_last=True` zeroes the output layer
    (Glow-style identity init of a coupling layer; see the JAX twin)."""
    dtype = dtype or torch.get_default_dtype()
    w1, b1 = _linear_init(in_dim, hidden_dim, generator, device, dtype)
    w2, b2 = _linear_init(hidden_dim, hidden_dim, generator, device, dtype)
    if zero_last:
        w3 = torch.zeros(hidden_dim, out_dim, device=device, dtype=dtype)
        b3 = torch.zeros(out_dim, device=device, dtype=dtype)
    else:
        w3, b3 = _linear_init(hidden_dim, out_dim, generator, device, dtype)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}


def mlp_apply(params, x):
    """tanh(x @ w1 + b1) -> tanh(. @ w2 + b2) -> . @ w3 + b3."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


class MLP(nn.Module):
    """`mlp_apply` on the parameters `mlp_init` draws."""

    def __init__(self, in_dim, out_dim, hidden_dim, zero_last=False,
                 generator=None, device=None, dtype=None):
        super().__init__()
        for name, t in mlp_init(in_dim, out_dim, hidden_dim, zero_last,
                                generator, device, dtype).items():
            setattr(self, name, nn.Parameter(t))

    def forward(self, x):
        return mlp_apply(self._parameters, x)
