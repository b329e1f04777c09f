"""lj32_nsf_ar on the program: NormalizingFlow(EinsteinCrystal, Chain(
[SplineAR] * nlayers)) at the configuration's widths, with the benchmark's
weights and lattice copied in."""

from __future__ import annotations

import torch

from nfbench.ports import load_weights


def build(cfg, params, centers, half_box, device):
    """The program's flow holding `params`, its prior on `centers`."""
    from normalizingflow_tpu_torch.bijectors import Chain, SplineAR
    from normalizingflow_tpu_torch.distributions import EinsteinCrystal
    from normalizingflow_tpu_torch.flow import NormalizingFlow

    kw = dict(device=device, dtype=torch.float32)
    n = cfg["nparticles"] * cfg["dim"]
    prior = EinsteinCrystal(centers, alpha=cfg["prior_alpha"],
                            boxlength=2.0 * half_box, point_dim=cfg["dim"],
                            **kw)
    flow = NormalizingFlow(prior, Chain([
        SplineAR(n, num_bins=cfg["nsplines"], tail_bound=half_box,
                 hidden_dim=cfg["hidden_dim"], periodic=cfg["periodic"],
                 **kw)
        for _ in range(cfg["nlayers"])]))
    load_weights(flow, params)
    return flow
