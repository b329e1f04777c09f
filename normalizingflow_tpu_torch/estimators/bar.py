"""Bennett acceptance ratio (BAR) free-energy estimator.
Twin of normalizingflow_tpu/estimators/bar.py.

The stable implicit-equation form with log-sum-exp reductions, iterated to
a fixed point delta <- delta - bar_zero(delta). The JAX `while_loop` is a
Python loop here with the same test: at most `maximum_iterations`, always
at least 2, then until the relative change is at most the tolerance. The
work values are a few thousand numbers; everything is float64, as the JAX
package computes under x64.
"""

from __future__ import annotations

import math

import torch

from ..bijectors.rqs import softplus


def bar_zero(w_f, w_r, delta_f):
    """The function zeroed by the BAR estimate. w_f: forward work values
    (T_F,); w_r: reverse work values (T_R,)."""
    t_f, t_r = w_f.shape[0], w_r.shape[0]
    m = math.log(t_f / t_r)
    log_numer = torch.logsumexp(-softplus(m + w_f - delta_f), dim=0) \
        - math.log(t_f)
    log_denom = torch.logsumexp(-softplus(m - w_r - delta_f) - w_r, dim=0) \
        - math.log(t_r)
    return delta_f - (log_denom - log_numer)


def bar(w_f, w_r, delta_f_init=0.0, maximum_iterations=1000,
        relative_tolerance=1.0e-5):
    """Self-consistent BAR solve: Delta F (float64 0-d tensor) such that
    bar_zero == 0."""
    w_f = torch.as_tensor(w_f).to(torch.float64)
    w_r = torch.as_tensor(w_r).to(w_f)
    delta = torch.as_tensor(delta_f_init).to(w_f)
    prev = torch.full_like(delta, math.inf)
    it = 0
    while it < maximum_iterations:
        if it >= 2:
            denom = torch.where(delta == 0.0, torch.ones_like(delta), delta)
            if not bool(torch.abs((delta - prev) / denom)
                        > relative_tolerance):
                break
        delta, prev = delta - bar_zero(w_f, w_r, delta), delta
        it += 1
    return delta
