"""Normalizing-flow model: prior + bijector, change-of-variables density.

Twin of normalizingflow_tpu/flow.py, same conventions:

  forward(x):  data -> latent; returns (z, prior_logprob(z), log_det_fwd)
  inverse(z):  latent -> data; returns (x, log_det_inv)
  sample(n):   z ~ prior; x = inverse(z); log_px = prior.log_prob(z) - log_det_inv
  log_prob(x) ("evaluate"): prior_logprob + log_det_fwd
"""

from __future__ import annotations

from torch import nn


class NormalizingFlow(nn.Module):
    def __init__(self, prior, bijector):
        super().__init__()
        self.prior = prior
        self.bijector = bijector

    def forward(self, x):
        z, log_det = self.bijector.forward(x)
        return z, self.prior.log_prob(z), log_det

    def inverse(self, z):
        return self.bijector.inverse(z)

    def sample(self, n_samples=None, generator=None, z=None):
        """Draw `n_samples` latents from the prior with `generator`, or push
        the given latents `z` (so a test can inject the prior draws)."""
        if z is None:
            z = self.prior.sample(n_samples, generator=generator)
        x, log_det = self.inverse(z)
        log_px = self.prior.log_prob(z) - log_det
        return x, log_px, z

    def log_prob(self, x):
        _, prior_logprob, log_det = self.forward(x)
        return prior_logprob + log_det

    evaluate = log_prob
