"""Self-contained MBAR solver (multistate Bennett acceptance ratio).
Twin of normalizingflow_tpu/estimators/mbar.py.

Given u[k, n], the reduced energy of sample n under state k, and sample
counts N_k, self-consistent iteration solves

    f_k = -log sum_n exp(-u[k,n] - log sum_j N_j exp(f_j - u[j,n]))

with f_0 = 0, from f = 0, for at most 500 iterations (at least 2) until
max |f - f_prev| is at most 1e-8: the JAX `while_loop` as a Python loop,
in float64.
"""

from __future__ import annotations

import torch


def mbar(u_kn, n_k, maximum_iterations=500, tolerance=1e-8):
    """Solve MBAR. u_kn: (K, N) reduced energies of all N pooled samples
    under each state; n_k: (K,) samples drawn from each state. Returns f_k
    (K,) reduced free energies, f[0] = 0, in float64."""
    u_kn = torch.as_tensor(u_kn).to(torch.float64)
    log_n = torch.log(torch.as_tensor(n_k).to(u_kn))

    def update(f):
        log_denom = torch.logsumexp((f + log_n)[:, None] - u_kn, dim=0)
        f_new = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
        return f_new - f_new[0]

    f = torch.zeros(u_kn.shape[0], dtype=u_kn.dtype, device=u_kn.device)
    prev = torch.full_like(f, float("inf"))
    it = 0
    while it < maximum_iterations:
        if it >= 2 and not bool(torch.max(torch.abs(f - prev)) > tolerance):
            break
        f, prev = update(f), f
        it += 1
    return f


def mbar_from_q(q):
    """Q work matrices (2, n, 2) -> (f_k, log c_k = -f_k). Q[i][:, k] is the
    log-density of trajectory i's samples under state k (state 0 = flow,
    state 1 = -U/kT); reduced energies are u = -logdensity."""
    q = torch.as_tensor(q)
    n = q.shape[1]
    u_kn = -torch.cat([q[0], q[1]], dim=0).T
    f = mbar(u_kn, [n, n])
    return f, -f
