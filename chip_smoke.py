#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (normalizingflow_tpu_torch) on one GPU.

    python3 chip_smoke.py           # reduced depth, about two minutes on an H100
    python3 chip_smoke.py --full    # the bench's depth: 15000 train steps,
                                    # 1024 draws

Phases, each printing its own line; any failure exits non-zero:
  1. device : the card's name and power limit from nvidia-smi;
  2. build  : compiles every CUDA kernel of the path from csrc/ with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
              the main path's shapes and beyond, with NaN/inf rows; times
              with CUDA events beside the plain version and the byte bound;
  4. main   : the bench's funnel line at full width -- RealNVP (ActNorm +
              2 x AffineCoupling, hidden 128) on NealsFunnel(64), reverse-KL
              training at batch 4096, NeuTra-HMC with 8192 chains, warmup
              100, L=8, push to data space, bulk and tail ESS -- with the
              kernels' launch counts, and checks of the funnel's statistics.
Then one JSON line describing every kernel, and last the JSON status line.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), used for bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DIM, HIDDEN, LAYERS = 64, 128, 2
CHAINS, WARMUP, LEAPFROG = 8192, 100, 8
TRAIN_BATCH = 4096
FULL_TRAIN_STEPS, FULL_DRAWS = 15000, 1024  # bench.py's depth
REDUCED_TRAIN_STEPS, REDUCED_DRAWS = 5000, 256
KERNEL_SHAPES = [(8192, 64), (1056, 64), (300, 2048), (96, 6)]


def log(*a):
    print(*a, flush=True)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=50, flush=None):
    """Median per-call device time (CUDA events around each call).

    Before each call the device spins for about half a millisecond, so the
    host has queued the whole call before its start event fires and the
    time is the device's, not the host's launch overhead. `flush` (a large
    buffer) is overwritten before each call, outside the timed region, so
    the call finds its inputs in HBM and not in L2."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ------------------------------------------------------------ accept/select
def accept_inputs(n, d, gen):
    """Random chain state with mixed accepts and divergent rows.

    h_old is set around h_new so that dE ~ N(0, 1) and about half the rows
    accept. Rows 0::7 have a NaN lp_new, rows 1::7 a NaN q and an inf
    momentum, rows 2::7 a NaN h_old: all must be rejected, with
    accept_prob 0 where h_new is not finite.
    """
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    q, p, g_new, pos_old, g_old = (torch.randn(n, d, **kw) for _ in range(5))
    lp_new, lp_old = torch.randn(n, **kw), torch.randn(n, **kw)
    inv_m = torch.exp(0.3 * torch.randn(d, **kw))
    kin = 0.5 * torch.sum(inv_m.double() * p.double() ** 2, dim=1)
    h_old = (-lp_new.double() + kin + torch.randn(n, **kw).double()).float()
    log_u = torch.log(torch.rand(n, **kw))
    lp_new[0::7] = float("nan")
    q[1::7] = float("nan")
    p[1::7, 0] = float("inf")
    h_old[2::7] = float("nan")
    return q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_m


def accept_bound(args, accepted):
    """Least time for this data: p, the selected position and gradient
    rows, the per-row scalars (lp_old only where rejected) and inv_mass
    read once; the outputs written once."""
    q, p, *_, inv_m = args
    n, d = q.shape
    rejected = int((~accepted).sum())
    read = 4 * (3 * n * d + 3 * n + rejected + d)
    write = 4 * (2 * n * d + 3 * n) + n
    ops = 3 * n * d + 10 * n
    t_bytes = (read + write) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_accept_select(n, d, gen, flush):
    from normalizingflow_tpu_torch.ops.hmc import (
        accept_select,
        accept_select_ref,
    )

    args = accept_inputs(n, d, gen)
    q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_m = args
    ref = accept_select_ref(*args)
    ker = accept_select(*args)  # CUDA tensors: the kernel
    torch.cuda.synchronize()
    pos_r, lp_r, g_r, ap_r, acc_r, de_r = ref
    pos_k, lp_k, g_k, ap_k, acc_k, de_k = ker

    # The kernel sums the kinetic energy in another order than torch.sum,
    # so dE may differ by a few f32 ulps of the terms it is made of: the
    # tolerance is relative to |h_old| + |lp_new| + kin. A row whose
    # accept test lies within that of log_u may flip; it is excluded and
    # counted.
    kin = 0.5 * torch.sum(inv_m * p * p, dim=1)
    scale = (h_old.abs() + lp_new.abs() + kin).nan_to_num(0.0, 0.0, 0.0)
    tol = 1e-5 * torch.clamp(scale, min=1.0)
    log_acc = torch.clamp(de_r, max=0.0)
    near = (log_u - log_acc).abs() < tol
    keep = ~near
    exact = dict(pos=(pos_k, pos_r), g=(g_k, g_r), lp=(lp_k, lp_r),
                 accepted=(acc_k, acc_r))
    for name, (a, b) in exact.items():
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0,
                                   equal_nan=True, msg=f"{name} ({n},{d})")
    finite = torch.isfinite(de_r)
    if not torch.equal(finite, torch.isfinite(de_k)):
        raise AssertionError(f"d_energy finiteness differs ({n},{d})")
    de_err = (de_k - de_r).abs()[finite]
    if bool((de_err > tol[finite]).any()):
        raise AssertionError(f"d_energy off by {float(de_err.max())}")
    ap_err = (ap_k - ap_r).abs()
    if bool((ap_err > 1e-5 + tol * ap_r).any()):
        raise AssertionError(f"accept_prob off by {float(ap_err.max())}")
    max_err = max(float(de_err.max()), float(ap_err.max()),
                  float((pos_k - pos_r)[keep].abs().nan_to_num(0.0).max()),
                  float((g_k - g_r)[keep].abs().nan_to_num(0.0).max()))
    n_acc = int(acc_r.sum())
    if not 0 < n_acc < n:
        raise AssertionError(f"inputs gave no mixed accepts ({n},{d})")

    ms = cuda_time_ms(lambda: accept_select(*args), flush=flush)
    ms_warm = cuda_time_ms(lambda: accept_select(*args))
    plain_ms = cuda_time_ms(lambda: accept_select_ref(*args), flush=flush)
    bound_ms, bound_by = accept_bound(args, acc_r)
    log(f"kernels: accept_select ({n},{d}) f32 ok: accepted {n_acc}/{n}, "
        f"excluded near-threshold {int(near.sum())}, max_abs_err {max_err:.3g}"
        f", ms {ms:.5f} (L2 warm {ms_warm:.5f}), plain_ms {plain_ms:.5f}, "
        f"bound_ms {bound_ms:.5f} ({bound_by}), "
        f"share of bound {bound_ms / ms:.3f}")
    return dict(max_abs_err=max_err, ms=ms, ms_warm=ms_warm,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------------------- main path
def build_flow(gen, device):
    from normalizingflow_tpu_torch import NormalizingFlow
    from normalizingflow_tpu_torch.bijectors import (
        ActNorm,
        AffineCoupling,
        Chain,
    )
    from normalizingflow_tpu_torch.distributions import DiagNormal

    kw = dict(device=device, dtype=torch.float32)
    return NormalizingFlow(
        DiagNormal(DIM, **kw),
        Chain([ActNorm(DIM, **kw)] + [
            AffineCoupling(DIM, hidden_dim=HIDDEN, generator=gen, **kw)
            for _ in range(LAYERS)]))


def main_path(train_steps, draws, seed, device="cuda"):
    from normalizingflow_tpu_torch.estimators.ess import (
        bulk_ess_per_dim,
        tail_ess,
    )
    from normalizingflow_tpu_torch.mcmc import neutra_hmc, padded_length
    from normalizingflow_tpu_torch.ops.hmc import accept_select
    from normalizingflow_tpu_torch.targets import NealsFunnel
    from normalizingflow_tpu_torch.train.loop import train

    gen = torch.Generator(device=device).manual_seed(seed)
    flow = build_flow(gen, device)
    target = NealsFunnel(DIM)

    accept_select.launches = 0
    t0 = time.perf_counter()
    final_kl = train(flow, target, train_steps, TRAIN_BATCH, gen,
                     device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = neutra_hmc(gen, flow, target, CHAINS, draws, num_warmup=WARMUP,
                     step_size=0.5, num_leapfrog=LEAPFROG, device=device)
    end.record()
    torch.cuda.synchronize()
    launches = accept_select.launches
    sample_s = start.elapsed_time(end) / 1e3
    transitions = padded_length(WARMUP) + padded_length(draws)

    xs = res.samples_x
    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    ess_min = float(torch.minimum(bulk_x.min(), bulk_x2.min()))
    hardest = int(torch.argmin(bulk_x))
    ess_tail = float(tail_ess(xs[:, :, hardest]))
    v = xs[..., 0]
    accept = float(res.accept_rate)
    stats = dict(
        reduced=train_steps < FULL_TRAIN_STEPS or draws < FULL_DRAWS,
        train_steps=train_steps, train_s=train_s, final_reverse_kl=final_kl,
        chains=CHAINS, warmup=WARMUP, draws=draws, leapfrog=LEAPFROG,
        transitions=transitions, accept_launches=launches,
        accept=accept, step_size=float(res.step_size),
        v_mean=float(v.mean()), v_var=float(v.var(correction=0)),
        ess_min_bulk_x=float(bulk_x.min()),
        ess_min_bulk_x2=float(bulk_x2.min()), ess_min=ess_min,
        ess_tail_hardest_coord=ess_tail,
        sample_s=sample_s, ess_per_s=ess_min / sample_s,
        ms_per_transition=sample_s * 1e3 / transitions)
    log("main: " + json.dumps(stats))

    if launches != transitions:
        raise AssertionError(f"accept_select launched {launches} times for "
                             f"{transitions} transitions")
    if not bool(torch.isfinite(xs).all()) or not all(
            math.isfinite(x) for x in (final_kl, ess_min, ess_tail, accept)):
        raise AssertionError("non-finite output")
    if xs.shape != (draws, CHAINS, DIM):
        raise AssertionError(f"samples shape {tuple(xs.shape)}")
    if not 0.6 <= accept <= 0.95:
        raise AssertionError(f"accept {accept} outside [0.6, 0.95]")
    if abs(stats["v_mean"]) >= 0.15 or abs(stats["v_var"] - 9.0) >= 0.9:
        raise AssertionError(
            f"funnel v stats off: mean {stats['v_mean']}, var "
            f"{stats['v_var']} (exact 0, 9)")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the bench's depth: 15000 train steps, 1024 draws")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from normalizingflow_tpu_torch.ops import _build
    from normalizingflow_tpu_torch.ops.hmc import KERNEL

    log(device_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build([KERNEL])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    results = {shape: check_accept_select(*shape, gen, flush)
               for shape in KERNEL_SHAPES}
    del flush

    train_steps, draws = ((FULL_TRAIN_STEPS, FULL_DRAWS) if args.full
                          else (REDUCED_TRAIN_STEPS, REDUCED_DRAWS))
    launches = main_path(train_steps, draws, args.seed)

    main_shape = results[(CHAINS, DIM)]
    kernels = [dict(
        name="accept_select", route="cuda",
        source="normalizingflow_tpu_torch/csrc/accept_select.cu",
        replaces="normalizingflow_tpu/ops/hmc_pallas.py:56",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in results.values()),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=None)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
