"""Variational objectives. Twin of normalizingflow_tpu/train/objectives.py.

  forward KL : -E_data[log p_model(x)]
  full KL    : -E_data[log p_model] + E_data[log p_target]
  reverse KL : E_model[log p_model - log p_target] = -ELBO

The prior draws of `reverse_kl` come from `generator`, or are passed in as
`z` so that a run can be compared draw for draw with the JAX package.
"""

from __future__ import annotations

import torch


def forward_kl_loss(flow, x):
    """-mean(prior_logprob + log_det), with the logged components."""
    _, prior_logprob, log_det = flow.forward(x)
    logprob = prior_logprob + log_det
    loss = -torch.mean(logprob)
    aux = {
        "logprob": torch.mean(logprob),
        "prior": torch.mean(prior_logprob),
        "log_det": torch.mean(log_det),
    }
    return loss, aux


def forward_kl(flow, target, x):
    """KL(data || model) up to the entropy constant."""
    loss, _ = forward_kl_loss(flow, x)
    return loss + torch.mean(target.log_prob(x))


def reverse_kl(flow, target, nsamples=None, generator=None, z=None):
    """E_model[log p_model - log p_target] over `nsamples` prior draws (or
    the given latents `z`); gradients flow through the reparameterized
    inverse pass."""
    x, log_px, _ = flow.sample(nsamples, generator=generator, z=z)
    return torch.mean(log_px) - torch.mean(target.log_prob(x))


def elbo(flow, target, nsamples=None, generator=None, z=None):
    return -reverse_kl(flow, target, nsamples, generator, z)
