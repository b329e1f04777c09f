"""Free-energy experiment CLI. Twin of normalizingflow_tpu/apps/fe.py.

`python -m normalizingflow_tpu_torch.apps.fe <config.yaml>
{training|testing}`

training: forward-KL training on the trajectory data (apps.train).
testing: 2000 flow samples, their mean log-density against that of 2000
test frames, then the BAR estimate over the independent data sets beside
the testing data (`../run_*/<testing file>`), or one `fe_diff` at 2000
samples where there are none. The numbers are also written to
`{testing_dir}/fe_{name}_testing.npz`.
"""

from __future__ import annotations

import glob
import os
import sys

import torch

from ..config import load_config
from .fe_eval import evaluate, fe_diff, fe_diff_ntrials, generate_from_nf
from .test import load_trained, save_estimates
from .train import main as train_main

NSAMPLES = 2000


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[1] not in ("training", "testing"):
        print("usage: python -m normalizingflow_tpu_torch.apps.fe "
              "<config.yaml> {training|testing}", file=sys.stderr)
        return 2
    if argv[1] == "training":
        return train_main([argv[0]])

    cfg = load_config(argv[0])
    flow, potential, cfg = load_trained(cfg)
    device = next(flow.parameters()).device
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)

    _, q1 = generate_from_nf(flow, NSAMPLES, batchsize=500, generator=gen)
    x2 = potential.sample(NSAMPLES, generator=gen)
    q2 = evaluate(flow, x2.reshape(len(x2), -1), batchsize=500)
    logp_gen, logp_data = float(q1.mean()), float(q2.mean())
    print("logp of generated data vs testing data:", logp_gen, logp_data)
    record = {"logp_generated": logp_gen, "logp_data": logp_data}

    pattern = os.path.join(
        os.path.dirname(cfg.dataset.testing_data or "."), "..", "run_*",
        os.path.basename(cfg.dataset.testing_data or ""))
    paths = sorted(glob.glob(pattern))
    if len(paths) > 1:
        mean, std, bars = fe_diff_ntrials(
            flow, potential, NSAMPLES, cfg.dataset.nparticles, paths,
            kT=cfg.dataset.kT, generator=gen)
        print(f"BAR dF over {len(paths)} datasets: {mean:.6f} +/- {std:.6f}")
        record.update(bar_mean=mean, bar_std=std, bars=bars)
    else:
        out = fe_diff(flow, potential, NSAMPLES, cfg.dataset.nparticles,
                      kT=cfg.dataset.kT, generator=gen)
        print(f"bar={out['bar']:.6f} md={out['md']:.6f} nf={out['nf']:.6f} "
              f"emus={out['emus']:.6f}")
        record.update(out)
    save_estimates(os.path.join(cfg.output.testing_dir,
                                f"fe_{cfg.dataset.name}_testing.npz"), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
