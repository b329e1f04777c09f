"""How far NeuTra-HMC on the bench's spline flow gets on the funnel.

Trains the spline line's flow as chip_smoke.py does (3 x SplineCoupling,
NealsFunnel(96), 2250 reverse-KL steps at batch 1024, lr 5e-4 / warmup
300), then prints one JSON line with

  * the flow's own push-forward statistics of v = x[0] (prior draws
    through flow.inverse), and its mass beyond the spline's tail bound;
  * NeuTra-HMC at 4096 chains, warmup 100, L = 8 (`--sampler hmc`, 1024
    draws), or NUTS at 1024 chains, warmup 100, max depth 7 (`--sampler
    nuts`, 64 draws), on the flow's pullback: accept, step size (NUTS: its
    mean depth and divergence rate too), and v's mean and variance in four
    consecutive blocks of draws, so a drift toward the exact (0, 9) shows
    as mixing.

    python tools/torch_spline_mixing.py [--sampler hmc|nuts] [--draws N]
                                        [--seed 0]

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
    SP_LR_WARMUP,
    SP_PEAK_LR,
    SP_TAIL,
    SP_TRAIN_STEPS,
    WARMUP,
    build_spline_flow,
)
from normalizingflow_tpu_torch.mcmc import (  # noqa: E402
    neutra_hmc,
    pullback_logprob_batched,
    push_to_data,
    run_nuts,
)
from normalizingflow_tpu_torch.targets import NealsFunnel  # noqa: E402
from normalizingflow_tpu_torch.train.loop import train  # noqa: E402


NUTS_CHAINS = 1024


def v_stats(v):
    return dict(mean=float(v.mean()), var=float(v.var(correction=0)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sampler", choices=("hmc", "nuts"), default="hmc")
    ap.add_argument("--draws", type=int,
                    help="default: 1024 for hmc, 64 for nuts")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    flow = build_spline_flow(gen, "cuda")
    target = NealsFunnel(SP_DIM)
    t0 = time.perf_counter()
    kl = train(flow, target, SP_TRAIN_STEPS, SP_BATCH, gen,
               warmup_steps=SP_LR_WARMUP, peak_lr=SP_PEAK_LR)
    train_s = time.perf_counter() - t0

    z = flow.prior.sample(65536, generator=gen)
    v_flow = push_to_data(flow, z)[:, 0]
    t0 = time.perf_counter()
    if args.sampler == "hmc":
        draws = args.draws or 1024
        res = neutra_hmc(gen, flow, target, SP_CHAINS, draws,
                         num_warmup=WARMUP, step_size=0.5,
                         num_leapfrog=LEAPFROG)
        v = res.samples_x[..., 0]
        run = dict(sampler="hmc", chains=SP_CHAINS, leapfrog=LEAPFROG)
    else:
        draws = args.draws or 64
        flow.requires_grad_(False)
        res = run_nuts(gen, pullback_logprob_batched(flow, target),
                       flow.prior.sample(NUTS_CHAINS, generator=gen), draws,
                       num_warmup=WARMUP, step_size=0.5, max_depth=7)
        v = push_to_data(flow, res.samples)[..., 0]
        run = dict(sampler="nuts", chains=NUTS_CHAINS, max_depth=7,
                   mean_depth=float(res.mean_depth),
                   divergence_rate=float(res.divergence_rate))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    block = max(draws // 4, 1)
    print("mixing: " + json.dumps(dict(
        train_s=train_s, final_reverse_kl=kl,
        flow=dict(v_stats(v_flow),
                  share_beyond_tail=float((v_flow.abs() > SP_TAIL)
                                          .float().mean())),
        **run, warmup=WARMUP, draws=draws, sample_s=sample_s,
        accept=float(res.accept_rate), step_size=float(res.step_size),
        block=block, blocks=[v_stats(v[i:i + block])
                             for i in range(0, draws, block)],
        all_draws=v_stats(v), exact=dict(mean=0.0, var=9.0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
