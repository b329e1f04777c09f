"""Effective sample size (ESS) and potential scale reduction (R-hat).

Twin of normalizingflow_tpu/estimators/ess.py: FFT autocovariance with
Geyer initial-monotone-sequence truncation, split chains, rank
normalization (Vehtari et al. 2021). The core functions take x of shape
(draws, chains, *batch) and return (*batch); the JAX twin maps over the
batch instead. The per-dim functions work through the coordinates in
chunks, so that (8192 chains x 1024 draws) fits: peak memory scales with
draws * chains * dim_chunk.
"""

from __future__ import annotations

import torch


def _autocovariance_fft(x):
    """Per-chain autocovariance via FFT along the draws axis (dim 0)."""
    n = x.shape[0]
    x = x - torch.mean(x, dim=0, keepdim=True)
    m = 2 * n  # zero-padding (next pow2 not required for correctness)
    f = torch.fft.rfft(x, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def effective_sample_size(x):
    """ESS of (draws, chains, *batch) scalar chains -> (*batch).

    Pooled autocorrelation rho_t = 1 - (W - mean_chain_acov_t) / var_plus,
    summed over Geyer initial positive pairs.
    """
    n, m = x.shape[:2]
    acov = _autocovariance_fft(x)                  # (n, m, *b)
    chain_var = acov[0] * n / (n - 1.0)            # (m, *b)
    w = torch.mean(chain_var, dim=0)               # (*b)
    mean_acov = torch.mean(acov, dim=1)            # (n, *b)
    if m > 1:
        b_over_n = torch.var(torch.mean(x, dim=0), dim=0, correction=1)
        var_plus = w * (n - 1.0) / n + b_over_n
    else:
        var_plus = w * (n - 1.0) / n
    rho = 1.0 - (w - mean_acov) / var_plus         # (n, *b)

    # Geyer: sum consecutive pairs while positive (monotone estimator).
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(dim=1)
    pairs_min = torch.cummin(pairs, dim=0).values
    positive = pairs_min > 0.0
    tau = -1.0 + 2.0 * torch.sum(
        torch.where(positive, pairs_min, torch.zeros_like(pairs_min)), dim=0)
    tau = torch.clamp(tau, min=1e-8)
    return torch.clamp(n * m / tau, max=n * m * 1.0)


def _split_chains(x):
    """Split every chain in half: (n, m, ...) -> (n//2, 2m, ...). Drops the
    last draw when n is odd."""
    half = x.shape[0] // 2
    return torch.cat([x[:half], x[half: 2 * half]], dim=1)


def _rank_normalize(x):
    """Fractional-rank normal transform of the pooled draws of each batch
    element: rank r over all draws and chains -> Phi^-1((r - 3/8) /
    (S + 1/4)). Ranks are int64 and the quotient is taken in float64."""
    n, m = x.shape[:2]
    flat = x.reshape(n * m, -1)
    order = torch.argsort(flat, dim=0)
    ranks = torch.empty_like(order)
    ar = torch.arange(1, n * m + 1, dtype=torch.int64, device=x.device)
    ranks.scatter_(0, order, ar[:, None].expand_as(order))
    z = torch.special.ndtri((ranks.to(torch.float64) - 0.375)
                            / (n * m + 0.25))
    return z.reshape(x.shape).to(x.dtype)


def bulk_ess(x):
    """Split rank-normalized bulk ESS of (draws, chains, *batch)."""
    return effective_sample_size(_rank_normalize(_split_chains(x)))


def tail_ess(x):
    """Tail ESS of one parameter, x: (draws, chains): the min split-chain
    ESS of the 5% / 95% quantile indicator chains."""
    q05 = torch.quantile(x, 0.05)
    q95 = torch.quantile(x, 0.95)
    e05 = effective_sample_size(_split_chains((x <= q05).to(x.dtype)))
    e95 = effective_sample_size(_split_chains((x <= q95).to(x.dtype)))
    return torch.minimum(e05, e95)


def _per_dim(fn, samples, dim_chunk):
    dim = samples.shape[-1]
    return torch.cat([fn(samples[:, :, i: i + dim_chunk])
                      for i in range(0, dim, dim_chunk)])


def bulk_ess_per_dim(samples, dim_chunk=4):
    """samples: (draws, chains, dim) -> (dim,) rank-normalized bulk ESS."""
    return _per_dim(bulk_ess, samples, dim_chunk)


def ess_per_dim(samples, dim_chunk=8):
    """samples: (draws, chains, dim) -> (dim,) ESS per coordinate."""
    return _per_dim(effective_sample_size, samples, dim_chunk)


def min_ess(samples):
    return torch.min(ess_per_dim(samples))


def potential_scale_reduction(samples):
    """Split R-hat per dimension. samples: (draws, chains, dim) -> (dim,)."""
    x = _split_chains(samples)            # (half, 2m, dim)
    half = x.shape[0]
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    w = torch.mean(chain_var, dim=0)
    b = half * torch.var(chain_mean, dim=0, correction=1)
    var_plus = (half - 1.0) / half * w + b / half
    return torch.sqrt(var_plus / w)
