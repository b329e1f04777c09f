"""Where the port's NeuTra-HMC transition spends its time on the GPU.

At the bench's funnel shape (RealNVP dim 64, hidden 128, 2 layers, 8192
chains, L=8, f32; random flow weights from a seed -- a transition's cost
does not depend on training), this prints:

  * an end-to-end A/B of the transition's tail (last half-kick, both
    kinetic energies, accept, select: ops.hmc.accept_select_fused): ms per
    transition with the CUDA kernel and with its plain PyTorch version, in
    alternating pairs (kernel, plain, plain, kernel, ...), CUDA-event
    timed, each arm on its own copy of the state, in place as run_hmc
    runs it;
  * a torch.profiler breakdown of a few transitions: device time by
    kernel, and the device's busy share of the wall time.

    python tools/torch_transition_profile.py [--pairs 10] [--transitions 5]

Needs a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import CHAINS, DIM, LEAPFROG, build_flow  # noqa: E402
from normalizingflow_tpu_torch.mcmc import hmc  # noqa: E402
from normalizingflow_tpu_torch.mcmc.neutra import (  # noqa: E402
    pullback_logprob_batched,
)
from normalizingflow_tpu_torch.ops.hmc import (  # noqa: E402
    accept_select_fused,
    accept_select_fused_ref,
)
from normalizingflow_tpu_torch.targets import NealsFunnel  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--transitions", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flow = build_flow(gen, "cuda")
    for p in flow.parameters():
        p.requires_grad_(False)
    lp_grad = hmc.batched_lp_grad(
        pullback_logprob_batched(flow, NealsFunnel(DIM)))
    start = hmc.hmc_init(lp_grad, flow.prior.sample(CHAINS, generator=gen))
    inv_mass = torch.ones(DIM, device="cuda")
    step = torch.tensor(0.3, device="cuda")
    states = {arm: hmc.HMCState(*(t.clone() for t in start))
              for arm in ("kernel", "plain")}

    def run(n, arm="kernel"):
        for _ in range(n):
            draws = hmc.transition_draws(gen, CHAINS, DIM, torch.float32,
                                         "cuda")
            hmc.hmc_transition(lp_grad, states[arm], draws, step, LEAPFROG,
                               inv_mass, inplace=True)

    def ms_per_transition(arm):
        hmc.accept_select_fused = (accept_select_fused if arm == "kernel"
                                   else accept_select_fused_ref)
        try:
            run(1, arm)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            run(args.transitions, arm)
            e.record()
            torch.cuda.synchronize()
        finally:
            hmc.accept_select_fused = accept_select_fused
        return s.elapsed_time(e) / args.transitions

    arms = {"kernel": [], "plain": []}
    for i in range(args.pairs):
        order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
        for arm in order:
            arms[arm].append(ms_per_transition(arm))
    wins = sum(k < p for k, p in zip(arms["kernel"], arms["plain"]))
    print("ab: " + json.dumps({
        "ms_per_transition_kernel": arms["kernel"],
        "ms_per_transition_plain": arms["plain"],
        "median_kernel": statistics.median(arms["kernel"]),
        "median_plain": statistics.median(arms["plain"]),
        "kernel_wins": f"{wins}/{args.pairs}"}), flush=True)

    run(2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        s.record()
        run(args.transitions)
        e.record()
        torch.cuda.synchronize()
    wall_ms = s.elapsed_time(e)
    events = prof.key_averages()
    dev = [(ev.key, ev.device_time_total / 1e3, ev.count) for ev in events
           if ev.device_time_total > 0 and ev.device_type ==
           torch.autograd.DeviceType.CUDA]
    busy_ms = sum(t for _, t, _ in dev)
    dev.sort(key=lambda r: -r[1])
    print("profile: " + json.dumps({
        "transitions": args.transitions,
        "wall_ms_per_transition": wall_ms / args.transitions,
        "device_busy_ms_per_transition": busy_ms / args.transitions,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "kernels_per_transition": sum(c for *_, c in dev) / args.transitions,
        "top": [{"kernel": k[:90], "ms_per_transition": t / args.transitions,
                 "launches_per_transition": c / args.transitions}
                for k, t, c in dev[:12]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
