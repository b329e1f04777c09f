"""Where the port's slice-4 paths (EAM iron, phi^4, the polymer fields)
spend their time on the GPU.

On each config's model and target at full width (f32; random flow weights
from a seed: a step's cost does not depend on training), this prints one
JSON line each for:

  * fe_train   : a forward-KL step of configs/Fe_400K.yaml (2 x
                 SplineAR(162, 32 bins, hidden 354)) at batch 50;
  * fe_data    : an HMC transition of apps.sample_data (256 chains, L = 10)
                 on the tabulated EAM;
  * fe_ckpt    : one save_checkpoint of the training state (params, Adam);
  * phi4_train : a forward-KL step of configs/Phi4.yaml at batch 100;
  * phi4_rkl   : a reverse-KL fine-tune step at batch 256 (the SplineAR
                 inverse: 64 sequential RQS launches a layer, with their
                 gradient);
  * poly_train : a forward-KL step of configs/Polymer.yaml (2 x
                 SplineAR(2048, hidden 100)) at batch 40, with its peak
                 device memory;
  * poly_apply_all: the stacked MLPs' first layer at dim 2048: the
                 materialized `w1 * row_masks` (2047 x 2047 x 100 f32) alone,
                 the einsum alone, and the whole apply_all, in CUDA-event ms;
  * poly_sample: flow.sample(100) (2048 sequential steps a layer), and the
                 inverse's re-stacking of the columns alone (torch.stack +
                 zeros + cat at each step);
  * rnvp_train : a forward-KL step of configs/Polymer_rnvp.yaml (10 x
                 AffineCoupling hidden 4000) at batch 40, with its peak
                 memory;

steps as ms per call (host clock around synchronised calls), each
training, data and fine-tune step with a torch.profiler breakdown (device
busy ms, idle share, launches, top kernels).

    python tools/torch_fields_profile.py [--calls 3]

Needs a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from normalizingflow_tpu_torch.config import (  # noqa: E402
    load_config,
    setup_model,
)
from normalizingflow_tpu_torch.mcmc import hmc  # noqa: E402
from normalizingflow_tpu_torch.params import to_numpy  # noqa: E402
from normalizingflow_tpu_torch.train.checkpoint import (  # noqa: E402
    save_checkpoint,
)
from normalizingflow_tpu_torch.train.loop import (  # noqa: E402
    ClippedAdam,
    cosine_decay_schedule,
    make_optimizer,
    train_step,
)
from normalizingflow_tpu_torch.train.objectives import (  # noqa: E402
    forward_kl_loss,
)
from tools.torch_spline_profile import profile, wall_ms  # noqa: E402

CHAINS, LEAPFROG = 256, 10


def config(name, **dataset):
    """configs/<name>.yaml with repo-relative paths made absolute."""
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    prior = cfg.prior
    if isinstance(prior.centers, str):
        prior = dataclasses.replace(
            prior, centers=os.path.join(REPO, prior.centers))
    ds = cfg.dataset
    if ds.input_dir:
        ds = dataclasses.replace(ds, input_dir=os.path.join(REPO,
                                                            ds.input_dir))
    ds = dataclasses.replace(ds, **dataset)
    return dataclasses.replace(cfg, prior=prior, dataset=ds)


def event_ms(fn, reps=10):
    """Median device ms of fn between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def emit(label, out):
    print(f"{label}: " + json.dumps(out), flush=True)


def train_step_fn(flow, cfg, x):
    tp = cfg.train_parameters
    opt = make_optimizer(list(flow.parameters()), tp.learning_rate,
                         tp.scheduler, tp.lr_scheduler_gamma, tp.max_epochs)

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = forward_kl_loss(flow, x)
        loss.backward()
        opt.step()
    return step, opt


def report_train(label, flow, cfg, x, calls):
    step, opt = train_step_fn(flow, cfg, x)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = profile(step, calls, label)
    out["wall_ms_per_call"] = wall_ms(step, 2 * calls)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["params"] = sum(p.numel() for p in flow.parameters())
    emit(label, out)
    return opt


def fe(gen, calls):
    cfg = config("Fe_400K")
    flow, target, cfg = setup_model(cfg, generator=gen)
    x = flow.prior.sample(cfg.train_parameters.batch_size, generator=gen)
    opt = report_train("fe_train", flow, cfg, x, 10 * calls)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")

        def save():
            save_checkpoint(path, {"params": to_numpy(flow),
                                   "opt_state": opt.state_tree()})
        t0 = time.perf_counter()
        save()
        emit("fe_ckpt", {"save_s": time.perf_counter() - t0,
                         "bytes": os.path.getsize(path)})

    lp_grad = hmc.batched_lp_grad(target.log_prob)
    state = hmc.hmc_init(lp_grad, flow.prior.sample(CHAINS, generator=gen))
    inv_mass = torch.ones(target.dim, device="cuda")
    eps = torch.tensor(1e-3, device="cuda")

    def transition():
        nonlocal state
        draws = hmc.transition_draws(gen, CHAINS, target.dim, torch.float32,
                                     "cuda")
        state, _ = hmc.hmc_transition(lp_grad, state, draws, eps, LEAPFROG,
                                      inv_mass, inplace=True)

    out = profile(transition, 5 * calls, "fe_data")
    out["wall_ms_per_call"] = wall_ms(transition, 10 * calls)
    out["launches_per_gradient"] = out["launches_per_call"] / (LEAPFROG + 1)
    emit("fe_data", out)


def phi4(gen, calls):
    cfg = config("Phi4")
    flow, target, cfg = setup_model(cfg, generator=gen)
    x = flow.prior.sample(cfg.train_parameters.batch_size, generator=gen)
    report_train("phi4_train", flow, cfg, x, 10 * calls)
    tp = cfg.train_parameters
    opt = ClippedAdam(list(flow.parameters()),
                      cosine_decay_schedule(tp.rkl_finetune_lr, 2000))

    def rkl_step():
        z = flow.prior.sample(tp.rkl_finetune_batch, generator=gen)
        train_step(flow, target, opt, z)

    out = profile(rkl_step, calls, "phi4_rkl")
    out["wall_ms_per_call"] = wall_ms(rkl_step, 2 * calls)
    emit("phi4_rkl", out)


def polymer(gen, calls):
    # the training data are not needed here: a GFF stands in for the
    # config's trajectory file
    cfg = config("Polymer", potential="GaussianField")
    flow, _, cfg = setup_model(cfg, generator=gen)
    x = 0.5 * flow.prior.sample(cfg.train_parameters.batch_size,
                                generator=gen)
    report_train("poly_train", flow, cfg, x, calls)

    layer = flow.bijector.bijectors[0]
    mlp = layer.cond
    with torch.no_grad():
        feats = layer.features(x)
        w1m = mlp.w1 * mlp.row_masks[:, :, None]
        emit("poly_apply_all", {
            "batch": x.shape[0], "w1_gb": mlp.w1.numel() * 4 / 1e9,
            "mask_product_ms": event_ms(
                lambda: mlp.w1 * mlp.row_masks[:, :, None]),
            "einsum_ms": event_ms(
                lambda: torch.einsum("bf,ifh->ibh", feats, w1m)),
            "apply_all_ms": event_ms(lambda: mlp.apply_all(feats))})
        del w1m

        n, dim = 100, layer.dim
        z = flow.prior.sample(n, generator=gen)

        def restack():
            cols = [z[:, 0]]
            for i in range(1, dim):
                torch.cat([torch.stack(cols, dim=1),
                           z.new_zeros(n, dim - i)], 1)
                cols.append(z[:, i])

        emit("poly_sample", {
            "draws": n, "sample_ms": wall_ms(
                lambda: flow.sample(n, generator=gen), calls),
            "restack_ms_per_layer": wall_ms(restack, calls)})


def rnvp(gen, calls):
    cfg = config("Polymer_rnvp", potential="GaussianField")
    flow, _, cfg = setup_model(cfg, generator=gen)
    x = 0.5 * flow.prior.sample(cfg.train_parameters.batch_size,
                                generator=gen)
    report_train("rnvp_train", flow, cfg, x, calls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for part in (fe, phi4, polymer, rnvp):
        part(gen, args.calls)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
