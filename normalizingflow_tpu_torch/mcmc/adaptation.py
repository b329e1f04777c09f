"""Warmup adaptation: dual-averaging step size + Welford mass matrix.

Twin of normalizingflow_tpu/mcmc/adaptation.py. The states are tuples of
tensors that stay on the chains' device, so a warmup step never waits for
the host. Acceptance is averaged over the chain axis each step, and the
diagonal mass is the Welford variance pooled over chains x steps inside
each adaptation window. With a `mesh`, both are global over the ranks'
chains (parallel/sharded.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------- dual avg
class DualAveragingState(NamedTuple):
    log_step: torch.Tensor       # current log step size
    log_step_avg: torch.Tensor   # averaged iterate (used after warmup)
    h_bar: torch.Tensor          # running error statistic
    t: torch.Tensor              # iteration count
    mu: torch.Tensor             # shrinkage point = log(10 * eps0)


def da_init(step_size):
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        h_bar=torch.zeros_like(log_step),
        t=torch.zeros_like(log_step),
        mu=math.log(10.0) + log_step,
    )


def da_update(state, accept_prob, target_accept=0.8, gamma=0.05, t0=10.0,
              kappa=0.75):
    """One Nesterov dual-averaging step toward the target acceptance rate."""
    t = state.t + 1.0
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target_accept - accept_prob)
    log_step = state.mu - (torch.sqrt(t) / gamma) * h_bar
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, t, state.mu)


def da_step_size(state, averaged=False):
    return torch.exp(state.log_step_avg if averaged else state.log_step)


# ---------------------------------------------------------------- welford
class WelfordState(NamedTuple):
    mean: torch.Tensor   # (dim,)
    m2: torch.Tensor     # (dim,)
    count: torch.Tensor  # scalar


def welford_init(dim, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    return WelfordState(mean=torch.zeros(dim, **kw),
                        m2=torch.zeros(dim, **kw),
                        count=torch.zeros((), **kw))


def welford_update_batch(state, x, mesh=None):
    """Fold a (chains, dim) batch into the running moments (chunk update).

    With `mesh` (parallel.Mesh), `x` is this rank's rows of the chain
    batch and the batch's moments are global: its mean by one SUM
    all-reduce, then the squared deviations about that mean by a second."""
    if mesh is None:
        n_b = x.shape[0]
        mean_b = torch.mean(x, dim=0)
        m2_b = torch.sum((x - mean_b) ** 2, dim=0)
    else:
        n_b = x.shape[0] * mesh.size
        mean_b = mesh.mean(x)
        m2_b = mesh.sum(torch.sum((x - mean_b) ** 2, dim=0))
    n_a = state.count
    n = n_a + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * (n_b / n)
    m2 = state.m2 + m2_b + delta * delta * (n_a * n_b / n)
    return WelfordState(mean=mean, m2=m2, count=n)


def welford_variance(state, regularize=True):
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
    if regularize:
        # Stan's shrinkage toward unit variance for small sample counts.
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


# ---------------------------------------------------------------- schedule
def warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan-style window schedule, returned as numpy bool arrays
    (in_window, window_end) of length num_warmup. Mass adaptation
    accumulates where in_window; at each window_end the mass is refreshed
    and the Welford state and step-size averaging restart."""
    num_warmup = int(num_warmup)
    in_window = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < init_buffer + term_buffer + base_window:
        # Too short for windows: adapt step size only.
        return in_window, window_end
    start = init_buffer
    end = num_warmup - term_buffer
    size = base_window
    t = start
    while t < end:
        stop = min(t + size, end)
        if end - stop < base_window:  # absorb the tail into the last window
            stop = end
        in_window[t:stop] = True
        window_end[stop - 1] = True
        t = stop
        size *= 2
    return in_window, window_end
