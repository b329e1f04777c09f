"""Where the port's spline line spends its time on the GPU.

At the bench's spline shape (3 x SplineCoupling, 32 particles x 3, 32 bins,
B = 6, hidden 354, NealsFunnel(96), f32; random flow weights from a seed --
a step's cost does not depend on training), this prints one JSON line each
for:

  * train   : ms per reverse-KL step at batch 1024 (host clock around
              synchronised steps) and a torch.profiler breakdown of a few
              steps: device busy time, the device's idle share, launches,
              the top kernels;
  * sample  : the same for NeuTra-HMC transitions at 4096 chains, L = 8;
  * backward: the RQS backward's share. On the card the kernels' autograd
              Function runs the VJP kernel (csrc/rqs.cu); this times, on
              the inputs one gradient evaluation gives the RQS, that kernel
              alone and the float32 autograd recompute of the plain twin
              that it replaced, against the whole gradient evaluation, in
              device time and in wall time.

    python tools/torch_spline_profile.py [--steps 3] [--transitions 2]

Needs a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    LEAPFROG,
    SP_BATCH,
    SP_CHAINS,
    SP_DIM,
    SP_PEAK_LR,
    build_spline_flow,
)
from normalizingflow_tpu_torch.mcmc import hmc  # noqa: E402
from normalizingflow_tpu_torch.mcmc.neutra import (  # noqa: E402
    pullback_logprob_batched,
)
from normalizingflow_tpu_torch.ops import rqs as ops_rqs  # noqa: E402
from normalizingflow_tpu_torch.targets import NealsFunnel  # noqa: E402
from normalizingflow_tpu_torch.train.loop import (  # noqa: E402
    bench_optimizer,
    train_step,
)

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def wall_ms(fn, n):
    """Host-clock ms per call of fn over n synchronised calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile(fn, n, label):
    """Device busy ms, idle share, launches and top kernels per call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Kernels only: a record_function range of the host
    # (Optimizer.step#Adam.step) is also reported on the device, with the
    # time of the kernels inside it, which would count them twice.
    averages = prof.key_averages()
    host = {ev.key for ev in averages if ev.cpu_time_total > 0}
    dev = [(ev.key, ev.device_time_total / 1e3, ev.count)
           for ev in averages
           if ev.device_time_total > 0 and ev.key not in host
           and ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in dev)
    dev.sort(key=lambda r: -r[1])
    return {
        "phase": label, "calls": n,
        "profiled_wall_ms_per_call": wall / n,
        "device_busy_ms_per_call": busy / n,
        "device_idle_share": 1 - busy / wall,
        "launches_per_call": sum(c for *_, c in dev) / n,
        "top": [{"kernel": k[:90], "ms_per_call": t / n,
                 "launches_per_call": c / n} for k, t, c in dev[:10]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--transitions", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flow = build_spline_flow(gen, "cuda")
    target = NealsFunnel(SP_DIM)

    # ----------------------------------------------------------- training
    opt = bench_optimizer(list(flow.parameters()), 10**6, 300, SP_PEAK_LR)

    def step():
        train_step(flow, target, opt,
                   flow.prior.sample(SP_BATCH, generator=gen))

    out = profile(step, args.steps, "train")
    out["wall_ms_per_call"] = wall_ms(step, 3 * args.steps)
    print("train: " + json.dumps(out), flush=True)

    # ----------------------------------------------------------- sampling
    for p in flow.parameters():
        p.requires_grad_(False)
    lp_grad = hmc.batched_lp_grad(pullback_logprob_batched(flow, target))
    state = hmc.hmc_init(lp_grad, flow.prior.sample(SP_CHAINS, generator=gen))
    inv_mass = torch.ones(SP_DIM, device="cuda")
    eps = torch.tensor(0.3, device="cuda")

    def transition():
        nonlocal state
        draws = hmc.transition_draws(gen, SP_CHAINS, SP_DIM, torch.float32,
                                     "cuda")
        state, _ = hmc.hmc_transition(lp_grad, state, draws, eps, LEAPFROG,
                                      inv_mass, inplace=True)

    out = profile(transition, args.transitions, "sample")
    out["wall_ms_per_call"] = wall_ms(transition, 2 * args.transitions)
    print("sample: " + json.dumps(out), flush=True)

    # ------------------------------------------------- the RQS backward
    captured = []
    fused = ops_rqs.unconstrained_rqs_fused

    def capture(x, w, h, d, inverse, *bounds, **kw):
        captured.append((x.detach(), w.detach(), h.detach(), d.detach(),
                         inverse, bounds))
        return fused(x, w, h, d, inverse, *bounds, **kw)

    z = state.position
    ops_rqs.unconstrained_rqs_fused = capture
    try:
        lp_grad(z)
    finally:
        ops_rqs.unconstrained_rqs_fused = fused

    def backward(vjp):
        """One gradient evaluation's RQS backwards by `vjp`."""
        def run():
            for x, w, h, d, inverse, bounds in captured:
                one = torch.ones_like(x)
                vjp(x, w, h, d, one, one, inverse, *bounds)
        return run

    out = {"rqs_calls_per_gradient_evaluation": len(captured),
           "rows": [int(c[0].numel()) for c in captured]}
    for label, fn in (("gradient_evaluation", lambda: lp_grad(z)),
                      ("vjp_kernel", backward(ops_rqs.rqs_vjp_cuda)),
                      ("twin_recompute", backward(ops_rqs.twin_vjp))):
        out[label] = profile(fn, 3, label)
        out[label]["wall_ms_per_call"] = wall_ms(fn, 5)
    whole = out["gradient_evaluation"]
    for label in ("vjp_kernel", "twin_recompute"):
        out[label]["device_share_of_gradient_evaluation"] = (
            out[label]["device_busy_ms_per_call"]
            / whole["device_busy_ms_per_call"])
        out[label]["wall_share_of_gradient_evaluation"] = (
            out[label]["wall_ms_per_call"] / whole["wall_ms_per_call"])
    print("backward: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
