"""Training diagnostics: force matching and sample quality.
Twin of normalizingflow_tpu/train/diagnostics.py; both sides of the force
match are one autograd call."""

from __future__ import annotations

import torch


def force_matching(flow, target, x, kT=1.0):
    """Mean relative error between the flow's score d/dx log p_flow(x) and
    the target's force(x)/kT."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (predicted,) = torch.autograd.grad(flow.log_prob(xg).sum(), xg)
    actual = target.force(x) / kT
    rel = torch.linalg.norm(actual - predicted, dim=1) / (
        torch.linalg.norm(actual, dim=1) + 1e-12)
    return torch.mean(rel)


@torch.no_grad()
def held_out_logprob_gap(flow, data, nsamples=None, generator=None, z=None):
    """Mean log p of generated samples against held-out data: (gen, data,
    gap). The latents come from `generator`, or are `z`."""
    n = nsamples or data.shape[0]
    _, log_px, _ = flow.sample(n, generator=generator, z=z)
    gen, dat = torch.mean(log_px), torch.mean(flow.log_prob(data))
    return gen, dat, gen - dat
