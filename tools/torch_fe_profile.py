"""Where the port's free-energy pipeline spends its time on the GPU.

On configs/LJ.yaml's model and target at full width (NSF_AR, 2 x
SplineAR(96, 32 bins, hidden 354, periodic), EinsteinCrystal prior; LJ at
32 particles; f32; random flow weights from a seed -- a step's cost does
not depend on training), this prints one JSON line each for:

  * train : a forward-KL step (apps.train's) at batch 40 on lattice frames;
  * data  : an HMC transition of apps.sample_data (256 chains, L = 10) on
            the LJ target;
  * sample: generate_from_nf's batch of 500 (96 sequential RQS inverse
            launches a layer);
  * relax : relaxation_step on 500 frames, integrate_out_v's 10 x 500
            endpoints and one flat log_prob of 480000 RQS rows included;

each as ms per call (host clock around synchronised calls) and a
torch.profiler breakdown: device busy ms, the device's idle share,
launches, the top kernels.

    python tools/torch_fe_profile.py [--calls 3]

Needs a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from normalizingflow_tpu_torch.apps.fe_eval import (  # noqa: E402
    generate_from_nf,
)
from normalizingflow_tpu_torch.config import (  # noqa: E402
    load_config,
    setup_model,
)
from normalizingflow_tpu_torch.mcmc import hmc  # noqa: E402
from normalizingflow_tpu_torch.mcmc.relaxation import (  # noqa: E402
    relaxation_step,
)
from normalizingflow_tpu_torch.train.loop import make_optimizer  # noqa: E402
from normalizingflow_tpu_torch.train.objectives import (  # noqa: E402
    forward_kl_loss,
)
from tools.torch_spline_profile import profile, wall_ms  # noqa: E402

CHAINS, LEAPFROG, BATCH, FRAMES = 256, 10, 40, 500


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cfg = load_config(os.path.join(REPO, "configs", "LJ.yaml"))
    cfg = dataclasses.replace(cfg, prior=dataclasses.replace(
        cfg.prior, centers=os.path.join(REPO, cfg.prior.centers)))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flow, target, cfg = setup_model(cfg, generator=gen)
    dim = target.dim
    n = args.calls

    def report(label, fn, calls):
        out = profile(fn, calls, label)
        out["wall_ms_per_call"] = wall_ms(fn, 2 * calls)
        print(f"{label}: " + json.dumps(out), flush=True)

    # ----------------------------------------------------------- training
    tp = cfg.train_parameters
    opt = make_optimizer(list(flow.parameters()), tp.learning_rate,
                         tp.scheduler, tp.lr_scheduler_gamma, tp.max_epochs)
    frames = flow.prior.sample(BATCH, generator=gen)

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = forward_kl_loss(flow, frames)
        loss.backward()
        opt.step()

    report("train", step, 10 * n)

    # ------------------------------------------------ data: LJ transitions
    lp_grad = hmc.batched_lp_grad(target.log_prob)
    state = hmc.hmc_init(lp_grad, flow.prior.sample(CHAINS, generator=gen))
    inv_mass = torch.ones(dim, device="cuda")
    eps = torch.tensor(0.01, device="cuda")

    def transition():
        nonlocal state
        draws = hmc.transition_draws(gen, CHAINS, dim, torch.float32, "cuda")
        state, _ = hmc.hmc_transition(lp_grad, state, draws, eps, LEAPFROG,
                                      inv_mass, inplace=True)

    report("data", transition, 5 * n)

    # --------------------------------------------- sampling and relaxation
    for p in flow.parameters():
        p.requires_grad_(False)
    report("sample", lambda: generate_from_nf(flow, FRAMES, generator=gen),
           n)
    x = flow.prior.sample(FRAMES, generator=gen)
    report("relax", lambda: relaxation_step(flow, target, x, kT=cfg.dataset.kT,
                                            generator=gen), n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
