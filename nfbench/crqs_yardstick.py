"""The byte count of the circular RQS kernels (csrc/rqs.cu's
`rqs_circular_fwd` and `rqs_circular_vjp`), frozen, so that a later change
to the program cannot move the yardstick of `crqs_roofline.rkl_lj` and
`crqs_vjp_roofline.rkl_lj`.

As yardstick.rqs_bytes_ops counts the monotone kernels, in the 32-byte
sectors a call must read and write: every row is inside the domain (the
layer wraps its inputs), so each reads x and all of its w and h, and of d
(K logits a row) only the sectors holding its bin's two slope logits, idx
and idx + 1 mod K; the forward writes y and log|det|. The VJP reads gy
and gld too and writes gx, gw, gh and all of gd. Operations as the
monotone kernels'."""

from __future__ import annotations

import torch

from nfbench import yardstick


def crqs_bytes_ops(x, w, h, inverse, bounds):
    """((forward bytes, operations), (VJP bytes, operations)) of one
    circular call on rows x (n,), w and h (n, K)."""
    left, right, bottom, top = bounds
    lo, hi = (bottom, top) if inverse else (left, right)
    n, k = w.shape
    inside = (x >= lo) & (x <= hi)
    knots = yardstick._normalize_bins((h if inverse else w).double(), k,
                                      yardstick.MIN_BIN, lo, hi)
    idx = yardstick._search_bins(knots, x.double().clamp(lo, hi))[:, None]
    m = torch.arange(k, device=x.device)
    need_d = inside[:, None] & ((m == idx) | (m == (idx + 1) % k))
    every = torch.ones_like(inside)
    column = yardstick.sector_bytes(every)
    params = yardstick.sector_bytes(inside[:, None].expand(n, k))
    d_read = yardstick.sector_bytes(need_d)
    whole = yardstick.sector_bytes(every[:, None].expand(n, k))
    n_in = int(inside.sum())
    fwd = (3 * column + 2 * params + d_read, n_in * (28 * k + 50))
    vjp = (3 * column + yardstick.sector_bytes(inside) + 2 * params + d_read
           + 3 * whole, n_in * (36 * k + 200))
    return fwd, vjp


def crqs_roofline_pct(ctx, pattern, vjp):
    """A circular kernel's share of its roofline: the frozen byte count of
    one unit's calls (`ctx.layer["crqs_calls"]`, each on some of a call's
    spline rows and scaled to the `rows_per_unit` a call has), times the
    kernels the trace holds over the calls a unit makes, over their
    device time."""
    t, calls = ctx.trace, ctx.layer.get("crqs_calls")
    if t is None or not calls or ctx.hbm is None:
        return None
    seconds, count = t.kernel_seconds(pattern)
    if not count:
        return None
    bound = 0.0
    for x, w, h, inverse, bounds in calls:
        scale = ctx.layer["rows_per_unit"] / x.shape[0]
        fwd, back = crqs_bytes_ops(x, w, h, inverse, bounds)
        nbytes, ops = back if vjp else fwd
        bound += yardstick.bound_ms(nbytes * scale, ops * scale, ctx.hbm)
    bound *= count / len(calls)
    return 100.0 * bound / 1e3 / seconds
