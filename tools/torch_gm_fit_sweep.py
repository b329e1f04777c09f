"""GaussianMixture fit sweep on the card: the twin of tools/gm_fit_sweep.py
for normalizingflow_tpu_torch.

Trains variants of configs/GaussianMixture.yaml and reports the gap (mean
flow log-density of 2000 flow draws minus that of 2000 exact target draws,
the reference's own quality check) and the one-sided reverse-Zwanzig `nf`
estimate a particle (exact answer 0), so that the setting the config
ships is a reproducible decision.

The config now ships the sweep's winner (4 layers, 20000 epochs, batch
256, cosine). The sweep ran on the reference's hyperparameters, which the
config's header quotes and `ref` names: 1 layer, 2000 epochs, batch 40,
exponential decay (REFERENCE). Every variant's overrides apply over them,
so that the rows are the ones the config's figures record.

`nf` is computed in float64 (logsumexp of u1 - q1, minus log n), as the
port's estimators are on every device; the JAX tool keeps the draws'
dtype.

Usage: python tools/torch_gm_fit_sweep.py [variant ...] [--cpu]
(default: all 15). Runs on the card unless --cpu is given (without CUDA
it raises). Prints each row as one JSON line with the JAX tool's keys,
then the card and the kernels' launches in it, and the summary sorted by
|gap|; writes runs/torch_fit/gm_fit_sweep.json. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from normalizingflow_tpu_torch.config import (  # noqa: E402
    load_config,
    setup_model,
)
from normalizingflow_tpu_torch.device import entry_device  # noqa: E402
from normalizingflow_tpu_torch.ops import launch_counts  # noqa: E402
from normalizingflow_tpu_torch.train.fused import (  # noqa: E402
    train_flow_fused,
)
from tools.torch_fit_sweep import (  # noqa: E402
    OUT,
    row_extras,
    synchronize,
)

CONFIG = REPO / "configs" / "GaussianMixture.yaml"
NSAMPLES = 2000
REFERENCE = {"nlayers": 1, "max_epochs": 2000, "batch_size": 40,
             "scheduler": "exponential"}

VARIANTS = {
    # reference hyperparameters, verbatim (round-2 baseline: gap -1.03)
    "ref": {},
    # longer schedule, same lr
    "6k_cosine": {"max_epochs": 6000, "scheduler": "cosine"},
    # longer + hotter
    "6k_cosine_lr3e3": {"max_epochs": 6000, "scheduler": "cosine",
                        "learning_rate": 3e-3},
    # depth instead of schedule
    "2layer_6k": {"max_epochs": 6000, "scheduler": "cosine", "nlayers": 2},
    # reference epochs, hotter lr (Gaussian.yaml uses 5e-3)
    "lr5e3": {"learning_rate": 5e-3},
    # round 2 of the sweep: depth is what moved the needle
    "3layer_6k": {"max_epochs": 6000, "scheduler": "cosine", "nlayers": 3},
    "4layer_6k": {"max_epochs": 6000, "scheduler": "cosine", "nlayers": 4},
    "2layer_12k": {"max_epochs": 12000, "scheduler": "cosine", "nlayers": 2},
    "2layer_6k_bins32": {"max_epochs": 6000, "scheduler": "cosine",
                         "nlayers": 2, "nsplines": 32},
    "2layer_6k_nonper": {"max_epochs": 6000, "scheduler": "cosine",
                         "nlayers": 2, "periodic": False},
    # round 3: budget / width / batch at 4 layers
    "4layer_20k": {"max_epochs": 20000, "scheduler": "cosine", "nlayers": 4},
    "6layer_6k": {"max_epochs": 6000, "scheduler": "cosine", "nlayers": 6},
    "4layer_6k_b256": {"max_epochs": 6000, "scheduler": "cosine",
                       "nlayers": 4, "batch_size": 256},
    "4layer_6k_h160": {"max_epochs": 6000, "scheduler": "cosine",
                       "nlayers": 4, "hidden_dim": 160},
    "4layer_20k_b256": {"max_epochs": 20000, "scheduler": "cosine",
                        "nlayers": 4, "batch_size": 256},
}


def configure(overrides, base=REFERENCE):
    """configs/GaussianMixture.yaml with `base`, then `overrides`, over its
    flow (nlayers, nsplines, periodic, hidden_dim) and training (epochs,
    learning rate, scheduler, batch size); each replaces the value."""
    overrides = {**base, **overrides}
    cfg = load_config(CONFIG)
    fc = cfg.flow
    for k in ("nlayers", "nsplines", "periodic", "hidden_dim"):
        if k in overrides:
            fc = dataclasses.replace(fc, **{k: overrides[k]})
    tp = cfg.train_parameters
    tp = dataclasses.replace(
        tp,
        max_epochs=overrides.get("max_epochs", tp.max_epochs),
        learning_rate=overrides.get("learning_rate", tp.learning_rate),
        scheduler=overrides.get("scheduler", tp.scheduler),
        batch_size=overrides.get("batch_size", tp.batch_size),
    )
    return dataclasses.replace(cfg, flow=fc, train_parameters=tp)


@torch.no_grad()
def fit_metrics(flow, potential, cfg, n=NSAMPLES, draws=None):
    """{"logp_gen", "logp_test", "gap", "nf"} of `n` flow draws x1 and `n`
    exact target draws x2, both from a generator on the flow's device
    seeded with seed + 2, or from `draws`: {"z" the flow's latents, "x2"},
    each optional."""
    draws = draws or {}
    device = next(flow.parameters()).device
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    x1, q1, _ = flow.sample(n, generator=gen, z=draws.get("z"))
    x2 = draws.get("x2")
    if x2 is None:
        x2 = potential.sample(n, generator=gen)
    q2 = flow.log_prob(x2)
    # reverse Zwanzig over flow samples: log mean exp(logp_target -
    # logp_flow)
    u1 = potential.log_prob(x1)
    nf = (torch.logsumexp((u1 - q1).double(), 0) - math.log(n)) \
        / cfg.dataset.nparticles
    lp_gen, lp_test = float(torch.mean(q1)), float(torch.mean(q2))
    return {"logp_gen": lp_gen, "logp_test": lp_test,
            "gap": lp_gen - lp_test, "nf": float(nf)}


def run(name, overrides, base=REFERENCE, device="cuda", draws=None):
    """Train the variant `overrides` (over `base`) on `device` and measure
    it; prints the row and returns it with its card and launches."""
    device = entry_device(device)
    cfg = configure(overrides, base)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    flow, potential, cfg = setup_model(cfg, mode="training", device=device,
                                       generator=generator)
    tp = cfg.train_parameters
    before = launch_counts()
    synchronize(device)
    t0 = time.time()
    hist = train_flow_fused(
        flow, generator, potential, max_epochs=tp.max_epochs,
        batch_size=tp.batch_size, learning_rate=tp.learning_rate,
        scheduler=tp.scheduler, gamma=tp.lr_scheduler_gamma,
        output_freq=tp.output_freq, device=device)
    synchronize(device)
    train_s = time.time() - t0
    m = fit_metrics(flow, potential, cfg, draws=draws)
    out = {"variant": name, "overrides": overrides,
           "logp_gen": round(m["logp_gen"], 3),
           "logp_test": round(m["logp_test"], 3),
           "gap": round(m["gap"], 3), "rev_zwanzig_nf": round(m["nf"], 4),
           "best_logprob": round(hist["best_logprob"], 3),
           "train_s": round(train_s, 1)}
    print(json.dumps(out), flush=True)
    return dict(out, **row_extras(name, device, before))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = entry_device("cpu" if "--cpu" in argv else "cuda")
    names = [a for a in argv if a != "--cpu"] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; of {list(VARIANTS)}")
    out_path = OUT / "gm_fit_sweep.json"
    results = []
    for name in names:
        results.append(run(name, VARIANTS[name], device=device))
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(results, indent=1))
    print("\nsummary (gap closest to 0 wins):")
    for r in sorted(results, key=lambda r: abs(r["gap"])):
        print(f"  {r['variant']:18s} gap={r['gap']:+.3f} "
              f"nf={r['rev_zwanzig_nf']:+.4f} train={r['train_s']:.0f}s")
    print(f"rows -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
