"""funnel64_realnvp on the program: NormalizingFlow(DiagNormal, Chain(
[ActNorm] + AffineCoupling layers)) and NealsFunnel, with the benchmark's
weights copied in."""

from __future__ import annotations

import torch

from nfbench.ports import load_weights


def build(cfg, params, device):
    """(flow, target) of the program, holding `params`."""
    from normalizingflow_tpu_torch.bijectors import (
        ActNorm,
        AffineCoupling,
        Chain,
    )
    from normalizingflow_tpu_torch.distributions import DiagNormal
    from normalizingflow_tpu_torch.flow import NormalizingFlow
    from normalizingflow_tpu_torch.targets import NealsFunnel

    kw = dict(device=device, dtype=torch.float32)
    d = cfg["dim"]
    layers = [ActNorm(d, **kw)] if cfg["actnorm"] else []
    layers += [AffineCoupling(d, hidden_dim=cfg["hidden_dim"], **kw)
               for _ in range(cfg["layers"])]
    flow = NormalizingFlow(DiagNormal(d, **kw), Chain(layers))
    load_weights(flow, params)
    return flow, NealsFunnel(d)
