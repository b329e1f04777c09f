"""Zwanzig exponential-averaging (free-energy perturbation) estimators.
Twin of normalizingflow_tpu/estimators/zwanzig.py, in float64:

    Delta F = -log < exp(-w) >  over work values w, by logsumexp.
"""

from __future__ import annotations

import math

import torch


def zwanzig(work):
    """Delta F = -log mean(exp(-work)), stable, as a float64 0-d tensor."""
    work = torch.as_tensor(work).to(torch.float64)
    return -(torch.logsumexp(-work, dim=0) - math.log(work.shape[0]))


def zwanzig_forward(u_target, u_ref):
    """FEP from reference-ensemble samples: w = u_target - u_ref."""
    return zwanzig(torch.as_tensor(u_target).to(torch.float64)
                   - torch.as_tensor(u_ref).to(torch.float64))
