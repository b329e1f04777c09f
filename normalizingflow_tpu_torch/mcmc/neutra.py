"""Flow-preconditioned HMC (NeuTra). Twin of normalizingflow_tpu/mcmc/neutra.py.

HMC runs in latent space z on the pullback density

    log pi~(z) = log pi(T(z)) + log|det dT/dz|,   T = flow.inverse (z -> x)

which a well-trained flow makes close to its (near-isotropic) prior, and
the latent draws are pushed back through T. `neutra_hmc` runs the
chain-batched form, one flow call per leapfrog step for all chains;
`pullback_logprob` is JAX's per-point form, for `batched_target=False`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..device import check_on, entry_device
from .hmc import run_hmc

PUSH_CHUNK = 65536  # latent rows per flow.inverse call in the push


def pullback_logprob(flow, target):
    """(dim,) -> () latent log-density of one point. Use it under
    `frozen(flow)`, so that a gradient in z builds no graph to the
    parameters; `torch.func.vmap` of it runs the flow once on the batch."""

    def logprob(z):
        x, log_det = flow.inverse(z[None])
        return target.log_prob(x)[0] + log_det[0]

    return logprob


def pullback_logprob_batched(flow, target):
    """(chains, dim) -> (chains,) latent log-density, in ONE flow call."""

    def logprob(z):
        x, log_det = flow.inverse(z)
        return target.log_prob(x) + log_det

    return logprob


class NeutraResult(NamedTuple):
    samples_x: torch.Tensor     # (num_samples, chains, dim) data space
    samples_z: torch.Tensor     # latent space
    accept_rate: torch.Tensor
    step_size: torch.Tensor


@contextlib.contextmanager
def frozen(flow):
    """The flow's parameters take no gradient inside (HMC needs the
    gradient in z only); their flags are restored after."""
    params = list(flow.parameters())
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        yield flow
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def push_to_data(flow, zs, chunk=PUSH_CHUNK):
    """x = flow.inverse(z) for latents zs (..., dim), `chunk` rows a call.

    Rows are independent, so chunking changes no value; it bounds the
    memory of one call (at 4096 chains x 256 draws a spline layer's
    conditioner output alone would be 25 GB)."""
    flat = zs.reshape(-1, zs.shape[-1])
    with torch.no_grad():
        x = torch.cat([flow.inverse(part)[0] for part in flat.split(chunk)])
    return x.reshape(zs.shape)


def neutra_hmc(generator, flow, target, num_chains, num_samples,
               num_warmup=200, step_size=0.5, num_leapfrog=8,
               target_accept=0.8, thin=1, device="cuda"):
    """Run flow-preconditioned HMC; returns samples in data space.

    Chains start from prior draws, in the typical set of the pullback. The
    flow's parameters do not require grad during the run (HMC needs the
    gradient in z only), and are restored afterwards. The draws are pushed
    to data space PUSH_CHUNK rows at a time.
    """
    device = entry_device(device)
    check_on(device, *flow.parameters())
    with frozen(flow):
        z0 = flow.prior.sample(num_chains, generator=generator)
        result = run_hmc(
            generator, pullback_logprob_batched(flow, target), z0,
            num_samples, num_warmup=num_warmup, step_size=step_size,
            num_leapfrog=num_leapfrog, target_accept=target_accept,
            thin=thin, device=device)
        zs = result.samples
        x = push_to_data(flow, zs)
    return NeutraResult(
        samples_x=x,
        samples_z=zs,
        accept_rate=result.accept_rate,
        step_size=result.step_size,
    )
