"""Headline benchmark of the port: flow-preconditioned HMC effective
samples a second. Twin of bench.py.

    python -m normalizingflow_tpu_torch.bench

prints ONE JSON line, the last on stdout, under bench.py's metric name
`neutra_hmc_ess_per_s_funnel64` (progress goes to stderr). It runs on the
card; there is no CPU fallback and no error field: a failure propagates
and the run exits non-zero.

Lines, as bench.py's:
  * funnel (the headline): RealNVP (ActNorm + 2 x AffineCoupling, hidden
    128) trained by reverse KL on the 64-d Neal's funnel, 15000 steps at
    batch 4096, then NeuTra-HMC with 8192 chains, 1024 draws, L = 8;
  * gaussian_secondary: the same on a 64-d Gaussian of condition 1e4;
  * nuts_funnel: NUTS on the funnel's pullback, 4096 chains, 256 draws,
    max depth 7;
  * spline_flow: 3 x SplineCoupling on the 96-d funnel, which runs the
    RQS kernels in training and sampling;
  * the speed-of-light row: the flow's forward and log-det at batch 8192
    on fresh weights: device time, GEMM FLOPs, MFU (utils/mfu.py).

ESS/s is bench.py's: an adaptation run first (warmup 100, 2 draws, step
0.5), one untimed warm call, then three timed runs, each sampling with no
warmup at the adapted step size and mass followed by the push to data
space. A timed window opens after torch.cuda.synchronize() and closes when
the host holds a value that depends on every draw. `sample_s` is the
fastest run, and the ESS (the min over coordinates of split rank-normalized
bulk ESS of x and x^2) comes from that same run's draws. Warmup never
counts.

Not ported: the spline line's A/B of the RQS kernel against XLA's lowering
(`*_xla`, `kernel_speedup_*`) and its TPU fault record (`sampling_error`,
`sampling_note`). The port has no switch between a kernel and its plain
version on the card, so its `*_fused` keys lose the suffix; the line lists
the dropped keys under "not_ported".
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import torch

from .bijectors import ActNorm, AffineCoupling, Chain, SplineCoupling
from .device import entry_device
from .distributions import DiagNormal
from .estimators.ess import bulk_ess_per_dim, ess_per_dim, tail_ess
from .flow import NormalizingFlow
from .mcmc import pullback_logprob_batched, push_to_data, run_hmc, run_nuts
from .mcmc.neutra import frozen
from .ops.hmc import accept_select_fused
from .targets import IllConditionedGaussian, NealsFunnel
from .train.loop import bench_optimizer, train, train_step
from .utils.mfu import device_time_us, gemm_flops, peak_flops

METRIC = "neutra_hmc_ess_per_s_funnel64"
BASELINE_ESS_PER_S = 1e6  # BASELINE.json's north star

DIM = 64
HIDDEN = 128
LAYERS = 2
# bench.py's settings, tuned there on a TPU v5e and kept so the two lines
# measure the same work.
CHAINS = 8192
DRAWS = 1024
WARMUP = 100
LEAPFROG = 8
TRAIN_STEPS = 15000
TRAIN_BATCH = 4096
LR_WARMUP, PEAK_LR = 500, 1e-3
TIMED_RUNS = 3

# IllConditionedGaussian(64, condition=1e4) of the JAX package permutes its
# stddevs by jax.random.permutation(PRNGKey(0), 64); torch cannot draw
# threefry's stream, so the port keeps that permutation.
GAUSS_CONDITION = 1e4
GAUSS_PERM = (
    0, 36, 1, 40, 19, 31, 39, 37, 41, 55, 53, 8, 12, 34, 16, 5, 24, 6, 51,
    20, 18, 45, 4, 58, 13, 43, 35, 30, 25, 56, 38, 28, 14, 3, 21, 60, 42, 32,
    10, 48, 17, 61, 29, 54, 2, 7, 44, 15, 57, 47, 52, 49, 26, 23, 50, 33, 63,
    11, 59, 62, 22, 27, 46, 9)

NUTS_CHAINS, NUTS_DRAWS, NUTS_MAX_DEPTH = 4096, 256, 7

SPLINE_PEAK_LR = 5e-4
SPLINE_NOT_PORTED = {
    **{k: "no kernel switch on the card: the RQS kernel always runs, so "
          "there is no XLA side to time" for k in (
              "ess_per_s_xla", "sample_s_xla", "accept_xla",
              "train_steps_per_s_xla", "kernel_speedup_sampling",
              "kernel_speedup_train")},
    **{k: "records a TPU runtime fault of the JAX package; the port's "
          "line never turns a failure into a field" for k in (
              "sampling_error", "sampling_note")},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def seeded(device, seed):
    """A torch.Generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed)


def synchronize(device):
    """Wait for the card's queue (the CPU has none)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_flow(layers=LAYERS, hidden=HIDDEN, dim=DIM, generator=None,
               device="cuda", dtype=torch.float32):
    """bench.py's flow: ActNorm + `layers` x AffineCoupling over a standard
    normal prior, its weights drawn from `generator`."""
    kw = dict(device=entry_device(device), dtype=dtype)
    return NormalizingFlow(DiagNormal(dim, **kw), Chain(
        [ActNorm(dim, **kw)]
        + [AffineCoupling(dim, hidden_dim=hidden, generator=generator, **kw)
           for _ in range(layers)]))


def gauss_target(device="cuda"):
    """The secondary line's IllConditionedGaussian(64, condition 1e4)."""
    return IllConditionedGaussian(DIM, GAUSS_PERM, condition=GAUSS_CONDITION,
                                  device=entry_device(device),
                                  dtype=torch.float32)


def fastest_of(run, device, reps=TIMED_RUNS):
    """Time `reps` calls of run() -> (result, checksum tensor). Each window
    opens after a synchronize and closes when the host has the checksum's
    value. Returns (the seconds of every call, the fastest call's
    result)."""
    times, best = [], None
    for _ in range(reps):
        synchronize(device)
        t0 = time.perf_counter()
        result, checksum = run()
        float(checksum)
        dt = time.perf_counter() - t0
        if not times or dt < min(times):
            best = result
        times.append(dt)
    return times, best


def sample_and_push(flow, target, generator, position, draws, step_size,
                    inv_mass_diag, leapfrog, device="cuda", replay=None):
    """One timed run: HMC on the NeuTra pullback from `position` with no
    warmup, at the given step size and inverse mass, then the push of the
    draws to data space. `replay` is run_hmc's `draws` (per-transition raw
    draws, to replay another run's numbers). Returns (x (draws, chains,
    dim), accept rate, x[-1].sum()): the last depends on every draw."""
    res = run_hmc(generator, pullback_logprob_batched(flow, target),
                  position, draws, num_warmup=0, step_size=step_size,
                  inv_mass_diag=inv_mass_diag, num_leapfrog=leapfrog,
                  draws=replay, device=device)
    x = push_to_data(flow, res.samples)
    return x, res.accept_rate, x[-1].sum()


def ess_summary(xs):
    """bench.py's ESS numbers of draws xs (draws, chains, dim), unrounded:
    the min and median bulk ESS of x, the min bulk ESS of x^2, the min raw
    ESS of both, the tail ESS of x's coordinate of least bulk ESS, and
    ess_min, the min of both bulk minima."""
    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    hardest = int(torch.argmin(bulk_x))
    return dict(
        ess_min=float(torch.minimum(bulk_x.min(), bulk_x2.min())),
        ess_min_bulk_x=float(bulk_x.min()),
        ess_min_bulk_x2=float(bulk_x2.min()),
        # jnp.median: the mean of the two middle values for an even count
        ess_median_bulk_x=float(torch.quantile(bulk_x, 0.5)),
        ess_min_raw_x=float(ess_per_dim(xs).min()),
        ess_min_raw_x2=float(ess_per_dim(xs * xs).min()),
        ess_tail_hardest_coord=float(tail_ess(xs[:, :, hardest])))


def timed_sampling(flow, target, generator, draws=DRAWS, chains=CHAINS,
                   leapfrog=LEAPFROG, device="cuda"):
    """The timed phase of bench.py's neutra_ess_run on a trained `flow`:
    adaptation (warmup 100, 2 draws, step 0.5) from `chains` prior draws,
    one warm call, then TIMED_RUNS timed `sample_and_push` runs at the
    adapted step size and mass. Returns the line's sampling keys, rounded
    as bench.py rounds them (ess_per_s unrounded), the fused accept
    kernel's launches in each timed run (0 on the CPU, where the plain
    version runs) and the fastest run's draws under "samples"."""
    device = entry_device(device)
    with frozen(flow):
        z0 = flow.prior.sample(chains, generator=generator)
        adapt = run_hmc(generator, pullback_logprob_batched(flow, target),
                        z0, 2, num_warmup=WARMUP, step_size=0.5,
                        num_leapfrog=leapfrog, device=device)
        step = float(adapt.step_size)
        launches = []

        def run():
            before = accept_select_fused.launches
            x, accept, checksum = sample_and_push(
                flow, target, generator, adapt.final_state.position, draws,
                step, adapt.inv_mass_diag, leapfrog, device=device)
            launches.append(accept_select_fused.launches - before)
            return (x, accept), checksum

        run()  # warm: the allocator, cuBLAS handles
        times, (xs, accept) = fastest_of(run, device)
    ess = ess_summary(xs)
    t_sample = min(times)
    return {
        "ess_per_s": ess["ess_min"] / t_sample,
        **{k: round(v, 1) for k, v in ess.items() if k != "ess_min"},
        "ess_cap": chains * draws,
        "sample_s": round(t_sample, 3),
        "sample_s_all": [round(t, 3) for t in times],
        "accept": round(float(accept), 3),
        "step_size": round(step, 4),
        "accept_launches_all": launches[1:],
        "chains": chains,
        "draws": draws,
        "leapfrog": leapfrog,
        "samples": xs,
    }


def neutra_ess_run(flow, target, generator, tag, leapfrog=LEAPFROG,
                   draws=DRAWS, chains=CHAINS, train_steps=TRAIN_STEPS,
                   train_batch=TRAIN_BATCH, lr_warmup=LR_WARMUP,
                   device="cuda"):
    """Train `flow` on `target` (bench.py's reverse-KL run: clip, Adam,
    warmup-cosine), then `timed_sampling`. Returns bench.py's keys, the
    draws under "samples"."""
    device = entry_device(device)
    synchronize(device)
    t0 = time.perf_counter()
    final_kl = train(flow, target, train_steps, train_batch, generator,
                     device=device, warmup_steps=lr_warmup, peak_lr=PEAK_LR)
    t_train = time.perf_counter() - t0
    log(tag, "train done", round(t_train, 1), "kl", round(final_kl, 3))
    out = timed_sampling(flow, target, generator, draws, chains, leapfrog,
                         device)
    log(tag, "ess/s", round(out["ess_per_s"], 1), "in", out["sample_s"],
        "s")
    out["train_s"] = round(t_train, 1)
    out["final_reverse_kl"] = round(final_kl, 3)
    return out


def gauss_line(generator, draws=DRAWS, train_steps=TRAIN_STEPS,
               device="cuda"):
    """bench.py's secondary line: `neutra_ess_run` of a fresh flow, its
    weights drawn from `generator`, on the Gaussian target; every float
    rounded to 0.1, as bench.py rounds this line."""
    device = entry_device(device)
    out = neutra_ess_run(build_flow(generator=generator, device=device),
                         gauss_target(device), generator, "gauss",
                         draws=draws, train_steps=train_steps, device=device)
    out.pop("samples")
    return {k: (round(v, 1) if isinstance(v, float) else v)
            for k, v in out.items()}


def funnel_v_stats(xs):
    """Mean and variance of the funnel's v over every draw (exact 0, 9)."""
    v = xs[..., 0]
    return {"v_mean": round(float(v.mean()), 3),
            "v_var": round(float(v.var(correction=0)), 3)}


def nuts_ess_line(flow, target, generator, chains=NUTS_CHAINS,
                  draws=NUTS_DRAWS, max_depth=NUTS_MAX_DEPTH, device="cuda"):
    """NUTS on the trained flow's pullback, bench.py's nuts_ess_line:
    the same protocol as `timed_sampling` with run_nuts."""
    device = entry_device(device)
    logprob = pullback_logprob_batched(flow, target)
    with frozen(flow):
        z0 = flow.prior.sample(chains, generator=generator)
        adapt = run_nuts(generator, logprob, z0, 2, num_warmup=WARMUP,
                         step_size=0.5, max_depth=max_depth, device=device)

        def run():
            res = run_nuts(generator, logprob, adapt.final_state.position,
                           draws, num_warmup=0,
                           step_size=float(adapt.step_size),
                           max_depth=max_depth,
                           inv_mass_diag=adapt.inv_mass_diag, device=device)
            x = push_to_data(flow, res.samples)
            return (x, res), x[-1].sum()

        run()
        times, (xs, res) = fastest_of(run, device)
    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    ess_min = float(torch.minimum(bulk_x.min(), bulk_x2.min()))
    t_sample = min(times)
    log("nuts", "ess done", round(ess_min, 1), "in", round(t_sample, 3),
        "s", "depth", round(float(res.mean_depth), 2))
    return {
        "ess_per_s": round(ess_min / t_sample, 1),
        "ess_min_bulk_x": round(float(bulk_x.min()), 1),
        "ess_min_bulk_x2": round(float(bulk_x2.min()), 1),
        "ess_cap": chains * draws,
        "sample_s": round(t_sample, 3),
        "sample_s_all": [round(t, 3) for t in times],
        "mean_tree_depth": round(float(res.mean_depth), 2),
        "divergence_rate": round(float(res.divergence_rate), 4),
        "accept": round(float(res.accept_rate), 3),
        "chains": chains,
        "draws": draws,
        "max_depth": max_depth,
    }


def spline_flow_lines(generator, size=32, num_bins=32, hidden=354,
                      tail_bound=6.0, chains=4096, draws=256, leapfrog=8,
                      train_steps=2250, train_batch=1024, lr_warmup=300,
                      chunk=250, device="cuda"):
    """bench.py's spline line without its A/B: 3 x SplineCoupling (`size`
    particles x 3 coordinates, cycling masks) on the funnel of 3 * size
    dims. train_steps_per_s over one `chunk` of steps on a throwaway copy
    from the same init (after a warm chunk), the real training run, then
    `timed_sampling`."""
    device = entry_device(device)
    dim = 3 * size
    kw = dict(device=device, dtype=torch.float32)
    target = NealsFunnel(dim)
    flow = NormalizingFlow(DiagNormal(dim, **kw), Chain([
        SplineCoupling(size, 3, num_bins=num_bins, tail_bound=tail_bound,
                       hidden_dim=hidden, mask=(axis,), generator=generator,
                       **kw)
        for axis in (0, 1, 2)]))
    out = {"dim": dim, "num_bins": num_bins, "layers": 3,
           "hidden_dim": hidden, "chains": chains, "draws": draws}

    scratch = copy.deepcopy(flow)
    opt = bench_optimizer(list(scratch.parameters()), train_steps, lr_warmup,
                          SPLINE_PEAK_LR)

    def chunk_of_steps():
        for _ in range(chunk):
            loss = train_step(scratch, target, opt, scratch.prior.sample(
                train_batch, generator=generator))
        return loss

    chunk_of_steps()  # warm
    synchronize(device)
    t0 = time.perf_counter()
    float(chunk_of_steps())
    out["train_steps_per_s"] = round(chunk / (time.perf_counter() - t0), 1)
    del scratch, opt

    final_kl = train(flow, target, train_steps, train_batch, generator,
                     device=device, warmup_steps=lr_warmup,
                     peak_lr=SPLINE_PEAK_LR)
    out["final_kl"] = round(final_kl, 3)
    log("spline", "train done, kl", out["final_kl"])

    s = timed_sampling(flow, target, generator, draws, chains, leapfrog,
                       device)
    out["ess_per_s"] = round(s["ess_per_s"], 1)
    out["sample_s"] = s["sample_s"]
    out["accept"] = s["accept"]
    out["accept_launches_all"] = s["accept_launches_all"]
    out["not_ported"] = SPLINE_NOT_PORTED
    log("spline", "ess/s", out["ess_per_s"], "in", out["sample_s"], "s")
    return out


def mfu_fwd_logdet(flow, generator, batch=CHAINS, device="cuda"):
    """bench.py's speed-of-light row: the flow's forward and log-det
    (z, prior log-prob, log-det) at `batch` prior-shaped inputs. FLOPs are
    GEMM FLOPs (utils/mfu.py), the time the median device time of one
    call; the card's GEMMs run in float32 (TF32 is off), so
    `sol_compute_us` is against the float32 peak, and MFU is given against
    both peaks."""
    device = entry_device(device)
    if device.type != "cuda":
        raise RuntimeError("the speed-of-light row is a device time: it "
                           "needs a CUDA device")
    peaks = peak_flops(torch.cuda.get_device_name(device))
    x = torch.randn(batch, flow.prior.dim, generator=generator,
                    device=device)

    def fwd():
        with torch.no_grad():
            return flow(x)

    flops = gemm_flops(fwd)
    sec = device_time_us(fwd) * 1e-6
    return {
        f"fwd_logdet_us_batch{batch}": round(sec * 1e6, 2),
        "fwd_logdet_gflop": round(flops / 1e9, 3),
        "achieved_tflops": round(flops / sec / 1e12, 2),
        "mfu_vs_bf16_peak": round(flops / sec / peaks["bf16"], 4),
        "mfu_vs_fp32_peak": round(flops / sec / peaks["fp32"], 4),
        "sol_compute_us": round(flops / peaks["fp32"] * 1e6, 2),
    }


def parse_power_limit(line):
    """Watts from an `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` line ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    return float(line.rsplit(",", 1)[1].split()[0])


def card_line(device):
    """nvidia-smi's "name, power.limit" line of the card `device`."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def headline(funnel, nuts, gauss, spline, mfu, device_name, power_limit_w):
    """bench.py's line from its parts: `funnel` holds timed_sampling's and
    neutra_ess_run's keys with the v statistics, its draws popped."""
    ess_per_s = funnel["ess_per_s"]
    return {
        "metric": METRIC,
        "value": round(ess_per_s, 1),
        "unit": "ESS/s",
        "vs_baseline": round(ess_per_s / BASELINE_ESS_PER_S, 4),
        "detail": {
            **{k: v for k, v in funnel.items() if k != "ess_per_s"},
            "flow_layers": LAYERS,
            "gaussian_secondary": gauss,
            "nuts_funnel": nuts,
            "spline_flow": spline,
            **mfu,
            "device": device_name,
            "power_limit_w": power_limit_w,
        },
    }


def main(device="cuda"):
    device = entry_device(device)
    power_limit_w = parse_power_limit(card_line(device))
    t0 = time.perf_counter()

    gen = seeded(device, 0)
    flow = build_flow(generator=gen, device=device)
    funnel = neutra_ess_run(flow, NealsFunnel(DIM), gen, "funnel",
                            device=device)
    funnel.update(funnel_v_stats(funnel.pop("samples")))

    nuts = nuts_ess_line(flow, NealsFunnel(DIM), seeded(device, 21),
                         device=device)

    # the same initial weights as the funnel's flow, as bench.py's key 0
    gauss = gauss_line(seeded(device, 0), device=device)

    gen = seeded(device, 5)
    mfu = mfu_fwd_logdet(build_flow(generator=gen, device=device), gen,
                         device=device)
    spline = spline_flow_lines(seeded(device, 40), device=device)

    line = headline(funnel, nuts, gauss, spline, mfu,
                    torch.cuda.get_device_name(device), power_limit_w)
    line["detail"]["bench_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
