"""Generate MD-equivalent training data with the port's HMC.
Twin of normalizingflow_tpu/apps/sample_data.py.

`python -m normalizingflow_tpu_torch.apps.sample_data <config.yaml>
[nframes] [--seed N] [--test-only out.npy]`

Warmup-adapted HMC chains (256 chains, warmup 500, step 0.05, L = 10, thin
2) run on the config's own differentiable potential at its kT, starting
from the prior, and the frames, wrapped into the box by minimum image, are
written 80/20 to the config's training and testing paths (.npy, or .xyz
for any other suffix), or all to one file with --test-only.

The JAX package runs the draws in segments of at most 8 after the warmup
segment, a TPU worker-crash workaround; the segments stay, because the
reported acceptance is their mean.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import build_potential, config_device, infer_boxlength, \
    load_config
from ..mcmc import run_hmc

SEGMENT = 8


def generate(cfg, nframes=2000, chains=256, thin=2, seed=0, device=None):
    """(frames (nframes, dim) tensor on the device, mean acceptance)."""
    device = config_device(cfg) if device is None else device
    _, boxlength = infer_boxlength(cfg.dataset)
    kw = dict(boxlength=boxlength, device=device, dtype=torch.float32)
    prior = build_potential(cfg.prior.type, cfg.prior, cfg.dataset, **kw)
    ds = cfg.dataset
    target = build_potential(ds.potential, ds, ds, **kw)

    gen = torch.Generator(device=device).manual_seed(seed)
    init = prior.sample(chains, generator=gen)
    draws = -(-nframes // chains)
    hmc = dict(num_leapfrog=10, thin=thin, device=device)
    res = run_hmc(gen, target.log_prob, init, num_samples=min(draws, SEGMENT),
                  num_warmup=500, step_size=0.05, **hmc)
    parts = [res.samples]
    accepts = [float(res.accept_rate)]
    done = min(draws, SEGMENT)
    while done < draws:
        res = run_hmc(gen, target.log_prob, res.final_state.position,
                      num_samples=min(draws - done, SEGMENT), num_warmup=0,
                      step_size=float(res.step_size),
                      inv_mass_diag=res.inv_mass_diag, **hmc)
        parts.append(res.samples)
        accepts.append(float(res.accept_rate))
        done += min(draws - done, SEGMENT)
    frames = torch.cat(parts).reshape(-1, init.shape[1])[:nframes]
    # HMC positions random-walk out of the periodic box; the flow's spline
    # domain is [-L/2, L/2], so wrap by minimum image, as LAMMPS does.
    box = getattr(target, "boxlength", None)
    if box:
        frames = frames - torch.round(frames / box) * box
    return frames, float(np.mean(accepts))


def _write(path, frames, n_particles):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, frames)
    else:
        from ..io.xyz import write_xyz

        write_xyz(path, frames, n_particles)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    seed = 0
    test_only = None
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--seed":
            seed = int(next(it))
        elif a == "--test-only":
            test_only = next(it)
        else:
            rest.append(a)
    if not rest:
        print("usage: python -m normalizingflow_tpu_torch.apps.sample_data "
              "<config.yaml> [nframes] [--seed N] [--test-only out.npy]",
              file=sys.stderr)
        return 2
    cfg = load_config(rest[0])
    nframes = int(rest[1]) if len(rest) > 1 else 2000

    frames, acc = generate(cfg, nframes, seed=seed)
    frames = frames.cpu().numpy()
    if test_only is not None:
        _write(test_only, frames, cfg.dataset.nparticles)
        print(f"wrote {len(frames)} independent test frames "
              f"(HMC acceptance {acc:.2f}, seed {seed}) -> {test_only}")
        return 0
    train_path = cfg.dataset.training_data
    test_path = cfg.dataset.testing_data
    n_train = int(0.8 * len(frames))
    for path, arr in ((train_path, frames[:n_train]),
                      (test_path, frames[n_train:])):
        if path is not None:
            _write(path, arr, cfg.dataset.nparticles)
    print(f"wrote {n_train} train + {len(frames) - n_train} test frames "
          f"(HMC acceptance {acc:.2f}) -> {train_path}, {test_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
