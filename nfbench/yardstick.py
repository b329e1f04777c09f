"""The benchmark's frozen arithmetic: ESS, device idle, byte bounds, peaks.

Copies, made so that a later change to the program cannot move the
yardstick:

  * ESS: `normalizingflow_tpu_torch/estimators/ess.py`'s split
    rank-normalized bulk ESS (FFT autocovariance, Geyer's initial monotone
    sequence, Vehtari et al. 2021), per coordinate in chunks;
  * device idle: `chip_smoke.py::device_idle`'s 1 - busy / window, with the
    busy time the union of the device's kernel, copy and set intervals;
  * byte bounds: `chip_smoke.py::fused_bound` (the HMC accept kernel) and
    `chip_smoke.py::rqs_bounds` (the RQS kernels), with their own copies of
    the knot and bin arithmetic;
  * peaks: `normalizingflow_tpu_torch/utils/mfu.py::PEAK_FLOPS` and
    chip_smoke's HBM bandwidth, the NVIDIA H100 SXM data sheet's figures at
    the card's full 700 W.
"""

from __future__ import annotations

import math

import torch

# Published dense peaks (FLOP/s) at the full 700 W power limit.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 66.9e12},
}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# chip_smoke.py's operation rate for the kernels' bounds
FP32_FLOPS_PER_S = 67e12


# ---------------------------------------------------------------- ESS
def _autocovariance_fft(x):
    n = x.shape[0]
    x = x - torch.mean(x, dim=0, keepdim=True)
    m = 2 * n
    f = torch.fft.rfft(x, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def effective_sample_size(x):
    """ESS of (draws, chains, *batch) scalar chains -> (*batch)."""
    n, m = x.shape[:2]
    acov = _autocovariance_fft(x)
    chain_var = acov[0] * n / (n - 1.0)
    w = torch.mean(chain_var, dim=0)
    mean_acov = torch.mean(acov, dim=1)
    if m > 1:
        b_over_n = torch.var(torch.mean(x, dim=0), dim=0, correction=1)
        var_plus = w * (n - 1.0) / n + b_over_n
    else:
        var_plus = w * (n - 1.0) / n
    rho = 1.0 - (w - mean_acov) / var_plus
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(dim=1)
    pairs_min = torch.cummin(pairs, dim=0).values
    positive = pairs_min > 0.0
    tau = -1.0 + 2.0 * torch.sum(
        torch.where(positive, pairs_min, torch.zeros_like(pairs_min)), dim=0)
    tau = torch.clamp(tau, min=1e-8)
    return torch.clamp(n * m / tau, max=n * m * 1.0)


def _split_chains(x):
    half = x.shape[0] // 2
    return torch.cat([x[:half], x[half: 2 * half]], dim=1)


def _rank_normalize(x):
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


def min_bulk_ess(parts, dim_chunk=4):
    """The min over coordinates of the bulk ESS of x and of x^2, for the
    draws `parts`: a list of (draws_i, chains, dim) tensors, consecutive in
    time, read `dim_chunk` coordinates at a time."""
    dim = parts[0].shape[-1]
    lo = math.inf
    for i in range(0, dim, dim_chunk):
        x = torch.cat([p[:, :, i:i + dim_chunk] for p in parts])
        lo = min(lo, float(bulk_ess(x).min()), float(bulk_ess(x * x).min()))
        del x
    return lo


# ------------------------------------------------------- device time
def union_seconds(intervals, lo, hi):
    """Seconds covered by the union of (start_ns, end_ns) intervals, clipped
    to [lo, hi] (ns)."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total / 1e9


def idle_share(busy_s, window_s):
    """device_idle's arithmetic: 1 - busy / window."""
    return 1.0 - busy_s / window_s


# ------------------------------------------------------------ bounds
def bound_ms(nbytes, ops, hbm):
    """Least ms of a call that moves `nbytes` and does `ops` fp32
    operations."""
    return max(nbytes / hbm, ops / FP32_FLOPS_PER_S) * 1e3


def fused_bound_bytes_ops(n, d, acc, inplace=True):
    """chip_smoke.py::fused_bound's count for one accept_select_fused call on
    (n, d) chains of which `acc` accept: (bytes, operations)."""
    rej = n - acc
    read = 4 * (3 * n * d + acc * d + 4 * n + d)
    write = 4 * (2 * acc * d + acc + 2 * n) + n
    if not inplace:
        read += 4 * 2 * rej * d
        write += 4 * (2 * rej * d + rej)
    return read + write, 8 * n * d + 20 * n


SECTOR_WORDS = 8  # float32 words in a 32-byte sector


def sector_bytes(need):
    """Bytes of the distinct 32-byte sectors holding the words that `need`
    (bool, shaped like a contiguous float32 array) marks."""
    flat = need.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % SECTOR_WORDS)])
    return 4 * SECTOR_WORDS * int(flat.view(-1, SECTOR_WORDS).any(1).sum())


def _normalize_bins(unnormalized, num_bins, min_size, lo, hi):
    probs = torch.softmax(unnormalized, dim=-1)
    probs = min_size + (1.0 - min_size * num_bins) * probs
    cum = torch.cumsum(probs, dim=-1)
    cum = (hi - lo) * cum + lo
    edge = cum[..., :1]
    return torch.cat([torch.full_like(edge, lo), cum[..., :-1],
                      torch.full_like(edge, hi)], dim=-1)


def _search_bins(knots, x):
    idx = torch.sum(x[..., None] >= knots, dim=-1) - 1
    return torch.clamp(idx, 0, knots.shape[-1] - 2)


MIN_BIN = 1e-3  # the spline's floors on bin widths and heights


def rqs_bytes_ops(x, w, h, inverse, bounds):
    """chip_smoke.py::rqs_bounds's count for one RQS call on rows x (n,),
    w and h (n, K): ((forward bytes, operations), (VJP bytes, operations)),
    counted in the 32-byte sectors the function must read and write. A row
    outside the domain needs x alone; a row inside all of its w and h and
    of d only its bin's two derivative logits; every output is written
    whole."""
    left, right, bottom, top = bounds
    lo, hi = (bottom, top) if inverse else (left, right)
    n, k = w.shape
    inside = (x >= lo) & (x <= hi)
    knots = _normalize_bins((h if inverse else w).double(), k, MIN_BIN, lo,
                            hi)
    idx = _search_bins(knots, x.double().clamp(lo, hi))[:, None]
    m = torch.arange(k - 1, device=x.device)
    need_d = inside[:, None] & ((m == idx - 1) | (m == idx))
    every = torch.ones_like(inside)
    column = sector_bytes(every)
    params = sector_bytes(inside[:, None].expand(n, k))
    d_read = sector_bytes(need_d)
    n_in = int(inside.sum())
    fwd = (3 * column + 2 * params + d_read, n_in * (28 * k + 50))
    vjp = (3 * column + sector_bytes(inside) + 2 * params + d_read
           + 2 * sector_bytes(every[:, None].expand(n, k))
           + sector_bytes(every[:, None].expand(n, k - 1)),
           n_in * (36 * k + 200))
    return fwd, vjp
