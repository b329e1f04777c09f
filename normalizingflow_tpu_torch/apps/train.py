"""Training CLI. Twin of normalizingflow_tpu/apps/train.py.

`python -m normalizingflow_tpu_torch.apps.train <config.yaml> [--resume]
[--hmc-mix]`

Forward-KL training on the config's data (train.fused.train_flow_fused),
with `{model_dir}/{name}.pt` as the best-model checkpoint and `.pt.last`
as the full training state. `--resume` continues exactly from `.pt.last`;
where there is none, it continues the JAX package's run from its
`{name}.msgpack.last` in the same model_dir (params, Adam state, epoch and
losses; the batches from then on are the port's own), and it starts fresh
only where neither exists. Either way the port writes its own `.pt` files.
With `--hmc-mix` or `train_parameters.hmc_mix`, the acceptance-gated HMC
mixer relaxes flow samples on the target (mcmc.relaxation.
collect_hmc_data); with `rkl_finetune_steps`, a reverse-KL fine-tune on
the target density follows and its model becomes the checkpoint.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch

from ..config import config_device, load_config, setup_model
from ..params import to_numpy
from ..train.checkpoint import save_checkpoint
from ..train.fused import train_flow_fused

MIX_SEED = 0x6D6978  # "mix": the mixer's generators are seeded apart


def checkpoint_path(cfg):
    return os.path.join(cfg.output.model_dir, f"{cfg.dataset.name}.pt")


def jax_checkpoint_path(cfg):
    """The JAX package's best-model checkpoint of the config's run."""
    return os.path.join(cfg.output.model_dir, f"{cfg.dataset.name}.msgpack")


def resume_path(cfg):
    """The training state `--resume` continues from: the port's
    `{name}.pt.last`, else the JAX package's `{name}.msgpack.last`, else
    None."""
    for path in (checkpoint_path(cfg) + ".last",
                 jax_checkpoint_path(cfg) + ".last"):
        if os.path.exists(path):
            return path
    return None


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    resume = "--resume" in argv
    hmc_mix_flag = "--hmc-mix" in argv
    argv = [a for a in argv if a not in ("--resume", "--hmc-mix")]
    if not argv:
        print("usage: python -m normalizingflow_tpu_torch.apps.train "
              "<config.yaml> [--resume] [--hmc-mix]", file=sys.stderr)
        return 2
    cfg = load_config(argv[0])
    logging.basicConfig(level=logging.INFO)
    device = config_device(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    flow, potential, cfg = setup_model(cfg, mode="training", device=device,
                                       generator=generator)
    tp = cfg.train_parameters
    os.makedirs(cfg.output.model_dir, exist_ok=True)
    ckpt = checkpoint_path(cfg)
    resume_from = resume_path(cfg) if resume else None
    if resume and resume_from is None:
        print(f"--resume: no checkpoint at {ckpt}.last or "
              f"{jax_checkpoint_path(cfg)}.last; starting fresh",
              file=sys.stderr)

    # Mixing needs a target with an energy to relax on; a pure trajectory
    # dataset has none.
    hmc_mixer = None
    if hmc_mix_flag or tp.hmc_mix:
        if hasattr(potential, "log_prob"):
            from ..mcmc.relaxation import collect_hmc_data

            def hmc_mixer(start):
                gen = torch.Generator(device=device).manual_seed(
                    cfg.seed * 1_000_003 + MIX_SEED + start)
                return collect_hmc_data(
                    flow, potential, n_chains=tp.hmc_mix_chains,
                    step_size=tp.hmc_mix_step_size,
                    num_leapfrog=tp.hmc_mix_leapfrog,
                    output_dir=cfg.output.training_dir,
                    n_particles=cfg.dataset.nparticles, generator=gen,
                    device=device)
        else:
            print("hmc_mix requested but the training target has no "
                  "log_prob (pure dataset); mixing disabled", file=sys.stderr)

    history = train_flow_fused(
        flow, generator, potential, max_epochs=tp.max_epochs,
        batch_size=tp.batch_size, learning_rate=tp.learning_rate,
        scheduler=tp.scheduler, gamma=tp.lr_scheduler_gamma,
        output_freq=tp.output_freq, checkpoint_path=ckpt,
        resume_from=resume_from, hmc_mixer=hmc_mixer, device=device)
    if resume_from:
        print(f"resumed from {resume_from} at epoch "
              f"{history['start_epoch']}")
    if tp.rkl_finetune_steps:
        if hasattr(potential, "log_prob"):
            from ..train.objectives import rkl_finetune

            rkl_loss = rkl_finetune(flow, potential, tp.rkl_finetune_steps,
                                    lr=tp.rkl_finetune_lr,
                                    batch=tp.rkl_finetune_batch)
            # the tuned model becomes the checkpoint the eval CLIs load;
            # .last keeps the forward-KL state for resume
            save_checkpoint(ckpt, {
                "params": to_numpy(flow), "opt_state": None,
                "generator": None, "epoch": tp.max_epochs,
                "losses": np.asarray(history["losses"])})
            print(f"rkl fine-tune: {tp.rkl_finetune_steps} steps, "
                  f"final reverse KL {rkl_loss:.3f}")
        else:
            print("rkl_finetune_steps set but the training target has no "
                  "log_prob (pure dataset); fine-tune skipped",
                  file=sys.stderr)
    print(f"best logprob: {history['best_logprob']:.3f}; checkpoint: {ckpt}; "
          f"Adam mu {history['adam_mu_dtype']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
