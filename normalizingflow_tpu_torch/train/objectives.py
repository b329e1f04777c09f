"""Variational objectives. Twin of normalizingflow_tpu/train/objectives.py.

  forward KL : -E_data[log p_model(x)]
  full KL    : -E_data[log p_model] + E_data[log p_target]
  reverse KL : E_model[log p_model - log p_target] = -ELBO

The prior draws of `reverse_kl` come from `generator`, or are passed in as
`z` so that a run can be compared draw for draw with the JAX package.
`rkl_finetune` is the JAX package's reverse-KL fine-tune from a forward-KL
fit; its chunked jit loop (a dispatch workaround) is a plain loop here.
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


def rkl_finetune(flow, target, steps, lr=1e-4, batch=256, seed=7,
                 generator=None, draws=None):
    """Reverse-KL fine-tune of `flow` in place: `steps` updates of
    clip_by_global_norm(1.0) + Adam with a cosine decay of `lr` to 0 over
    max(steps, 1), each on `batch` fresh prior draws. The draws come from
    `generator` (default: a generator on the flow's device seeded with
    `seed`), or from the iterator `draws` of (batch, dim) latents. Returns
    the last update's loss (before that update, as JAX reports it)."""
    from .loop import ClippedAdam, cosine_decay_schedule, train_step

    optimizer = ClippedAdam(list(flow.parameters()),
                            cosine_decay_schedule(lr, max(steps, 1)))
    if draws is None:
        device = next(flow.parameters()).device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        draws = (flow.prior.sample(batch, generator=generator)
                 for _ in range(steps))
    loss = torch.zeros(())
    for _, z in zip(range(steps), draws):
        loss = train_step(flow, target, optimizer, z)
    return float(loss)
