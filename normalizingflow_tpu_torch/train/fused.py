"""Forward-KL training of a flow on data: the apps' training loop.

Twin of normalizingflow_tpu/train/fused.py. The JAX package runs `chunk`
steps inside one jitted fori_loop per dispatch, a TPU dispatch workaround;
here every step is a plain Python iteration. The chunk still shapes the
results, so its effect is kept:

  * chunk = min(max(chunk, 400), max_epochs);
  * one `losses` entry per chunk, the chunk's mean loss, and one log line;
  * the best-model gate on the chunk's mean log-prob, with the best file an
    on-disk copy of a fresh `.last`, and `.last` written at the end, when a
    chunk is best, or when 4x the last save's cost has passed;
  * the acceptance-gated HMC mixer, run at chunk starts >= next_mix: when
    its acceptance lies in (0.3, 0.6), the first step of each chunk draws
    its batch from the mixer's relaxed data until the next check.

Adam's first moment follows the JAX package's memory policy
(`adam_mu_dtype`): bfloat16 where the projected training residency, 4.25x
the parameter bytes (params, both moments, grads, transients), exceeds the
device's budget; float32 otherwise. JAX's budget is the TPU v5e's 14.5e9 of
16 GB; the port takes the same share of the card's own memory, and keeps
14.5e9 on the CPU.

Minibatches: a source with a `traj` tensor (TrajectoryDataset) gathers
random rows of it on the device; any other source draws with its own
`sample`. Both take their draws from `generator`, whose state a checkpoint
keeps, so a resumed run continues the unbroken run's stream exactly. The
iterator `batches` replaces those draws (rows, or row indices into `traj`)
so a test can feed the JAX package's exact minibatches.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from ..device import check_on, entry_device
from ..params import from_jax, to_numpy
from .checkpoint import (
    copy_checkpoint,
    is_jax_checkpoint,
    jax_key_seed,
    load_checkpoint,
    read_jax_checkpoint,
    save_checkpoint,
)
from .loop import adam_state_from_optax, make_optimizer
from .objectives import forward_kl_loss

logger = logging.getLogger("normalizingflow_tpu_torch.train")

RESIDENCY_PER_PARAM_BYTE = 4.25  # params + mu + nu + grads + transients
BUDGET_SHARE = 14.5 / 16         # JAX's 14.5e9 of the v5e's 16 GB
CPU_BUDGET = 14.5e9


def adam_mu_dtype(param_bytes, device, capacity=None):
    """torch.bfloat16 if 4.25 x `param_bytes` exceeds the training budget,
    else None (the parameters' dtype). The budget is 14.5/16 of
    `capacity`, by default the card's total memory; on the CPU, without a
    capacity, it is JAX's 14.5e9."""
    if capacity is None and device.type == "cuda":
        capacity = torch.cuda.mem_get_info(device)[1]
    budget = CPU_BUDGET if capacity is None else BUDGET_SHARE * capacity
    if RESIDENCY_PER_PARAM_BYTE * param_bytes > budget:
        return torch.bfloat16
    return None


def train_flow_fused(flow, generator, data_source, *, max_epochs=4000,
                     batch_size=100, learning_rate=1e-4,
                     scheduler="exponential", gamma=0.999, output_freq=100,
                     checkpoint_path=None, chunk=500, resume_from=None,
                     hmc_mixer=None, mix_every=None, batches=None,
                     device="cuda"):
    """Train `flow` in place by forward KL on `data_source`; returns the
    history {"losses" (one per chunk), "best_logprob", "steps_per_s",
    "adam_mu_dtype" (the stored first moment's dtype)}.

    `resume_from`: a `.last` checkpoint of an earlier run; params, the
    optimizer, the generator's state, the epoch and the losses are restored
    and the run continues as the unbroken run would have. It may also be
    the JAX package's `.msgpack.last`: its params, optax's Adam moments and
    count (so the schedule continues at the same step), epoch and losses
    are restored, and `generator` is seeded from its PRNG key
    (checkpoint.jax_key_seed), so the batches differ from JAX's own
    continuation. If its epoch has reached `max_epochs`, the flow gets the
    checkpointed params and the history says `already_complete`. The
    history's `start_epoch` is the epoch the run started from.

    `hmc_mixer(start_epoch) -> (data (m, dim), acceptance)` is called every
    `mix_every` epochs (default 2 * output_freq), at chunk starts; it owns
    its randomness, so a failed gate leaves the training stream unchanged.
    """
    device = entry_device(device)
    check_on(device, *flow.parameters())
    params = list(flow.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    mu_dtype = adam_mu_dtype(param_bytes, device)
    if mu_dtype is not None:
        logger.info("large model (%.2f GB params): keeping Adam mu in "
                    "bfloat16", param_bytes / 1e9)
    optimizer = make_optimizer(params, learning_rate, scheduler, gamma,
                               max_epochs, mu_dtype=mu_dtype)
    mu_name = str(mu_dtype or params[0].dtype).removeprefix("torch.")

    start_epoch = 0
    losses = []
    best_logprob = -math.inf
    if resume_from:
        if is_jax_checkpoint(resume_from):
            state = read_jax_checkpoint(resume_from)
            from_jax(flow, state["params"])
            optimizer.load_state_tree(
                adam_state_from_optax(flow, state["opt_state"]))
            generator.manual_seed(jax_key_seed(state["key"]))
        else:
            state = load_checkpoint(resume_from, {"params": to_numpy(flow)})
            from_jax(flow, state["params"])
            optimizer.load_state_tree(state["opt_state"])
            generator.set_state(state["generator"])
        start_epoch = int(state["epoch"])
        losses = [float(v) for v in np.asarray(state["losses"])]
        # the reported log-prob is -loss, so the gate continues from there
        if losses:
            best_logprob = max(-v for v in losses)
        logger.info("resumed from %s at epoch %d", resume_from, start_epoch)

    traj = getattr(data_source, "traj", None)
    batches = None if batches is None else iter(batches)

    def sample_batch():
        if batches is not None:
            b = torch.as_tensor(next(batches), device=device)
            return b if b.is_floating_point() else traj[b]
        if traj is not None:
            idx = torch.randint(0, traj.shape[0], (batch_size,),
                                generator=generator, device=traj.device)
            return traj[idx]
        return data_source.sample(batch_size, generator=generator)

    chunk = min(max(chunk, 400), max_epochs)
    mixing = hmc_mixer is not None
    if mixing:
        mix_every = mix_every if mix_every is not None else 2 * output_freq

    bounds = range(start_epoch, max_epochs, chunk)
    if not bounds:
        logger.info("Training already complete (resumed at epoch %d >= "
                    "max_epochs %d); returning checkpointed parameters.",
                    start_epoch, max_epochs)
        return {"losses": np.asarray(losses), "best_logprob": best_logprob,
                "steps_per_s": 0.0, "already_complete": True,
                "adam_mu_dtype": mu_name, "start_epoch": start_epoch}

    mix_data, use_mix = None, False
    mix_log = []
    next_mix = start_epoch
    last_save_t = 0.0
    save_cost = 0.0
    t0 = time.time()
    for start in bounds:
        if mixing and start >= next_mix:
            mix_data, acc = hmc_mixer(start)
            accf = float(acc)
            use_mix = 0.3 < accf < 0.6
            next_mix = start + mix_every
            mix_log.append({"epoch": start, "acceptance": accf,
                            "mixed": use_mix})
            logger.info("HMC mix at epoch %d: acceptance %.3f -> %s", start,
                        accf, "relaxed data" if use_mix
                        else "dataset (gate failed)")
        n_steps = min(chunk, max_epochs - start)
        sums = None
        for i in range(n_steps):
            x = sample_batch()
            if use_mix and i == 0:
                idx = torch.randint(0, mix_data.shape[0], (batch_size,),
                                    generator=generator,
                                    device=mix_data.device)
                x = mix_data[idx].to(x)
            optimizer.zero_grad(set_to_none=True)
            loss, aux = forward_kl_loss(flow, x)
            loss.backward()
            optimizer.step()
            row = torch.stack([loss, aux["logprob"], aux["prior"],
                               aux["log_det"]]).detach()
            sums = row if sums is None else sums + row
        mean_loss, logprob, prior, log_det = (sums / n_steps).tolist()
        epoch = start + n_steps
        losses.append(mean_loss)
        rate = (epoch - start_epoch) / (time.time() - t0)
        logger.info("Iter: %d\tLoss: %.2f\tLogprob: %.2f\tPrior: %.2f\t"
                    "LogDet: %.2f\t(%.0f steps/s)", epoch, mean_loss, logprob,
                    prior, log_det, rate)
        need_best = logprob > best_logprob
        if checkpoint_path:
            final = epoch >= max_epochs
            due = (time.time() - last_save_t) >= 4.0 * save_cost
            if final or need_best or due:
                ts = time.time()
                save_checkpoint(checkpoint_path + ".last", {
                    "params": to_numpy(flow),
                    "opt_state": optimizer.state_tree(),
                    "generator": generator.get_state(), "epoch": epoch,
                    "losses": np.asarray(losses)})
                save_cost = time.time() - ts
                last_save_t = time.time()
            if need_best:
                copy_checkpoint(checkpoint_path + ".last", checkpoint_path)
        if need_best:
            best_logprob = logprob
    history = {"losses": np.asarray(losses), "best_logprob": best_logprob,
               "steps_per_s": (max_epochs - start_epoch)
               / (time.time() - t0),
               "adam_mu_dtype": mu_name, "start_epoch": start_epoch}
    if mixing:
        history["hmc_mixing"] = mix_log
    return history
