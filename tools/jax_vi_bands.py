#!/usr/bin/env python3
"""The JAX package's own results for tests/test_vi.py's spline recipe (BASELINE
config 3), the bands that chip_smoke.py's `vi` phase holds the port to.

    JAX_PLATFORMS=cpu python tools/jax_vi_bands.py [--seeds N] [--out PATH]

The recipe is test_spline_flow_on_correlated_gaussian's: 2 x
SplineCoupling(size, space_dim 2, K 8, tail bound 4, hidden 32, masks (0,)
and (1,)) + InvertibleLinear(dim) under a DiagNormal prior, 500
optax.adam(3e-3) steps of forward KL on 256 fresh target draws each, then
4000 flow draws and their round trip through the forward pass. It runs on
the CPU in float32 (the port's dtype on the card) for N seeds (params
PRNGKey(seed), step keys 2000 + 1000 * seed + i, draws PRNGKey(9 + seed))
on three targets:

  correlated8 : CorrelatedGaussian(8, rho 0.6), size 4 (the JAX test's own);
  correlated32: CorrelatedGaussian() = (32, rho 0.9), size 16 (BASELINE's
                "32-d correlated Gaussian");
  banana32    : Banana(32, b 0.1, s0 3.0), size 16, whose covariance is
                closed-form: diag(s0^2, 1 + 2 b^2 s0^4, 1, ...), 0 elsewhere.

For each run it prints `vi_stats` of the draws: var_rel, the largest
|variance / the target's - 1|; mean_sd, the largest |mean| in units of the
target's standard deviation; corr_err, the mean |error| of an off-diagonal
correlation (tools/vi_moments.py); and rt, the largest |forward(inverse(z))
- z|. It also prints what a perfect flow would give: each statistic's mean
and standard deviation over 200 sets of 4000 exact target draws (numpy).
That standard deviation is the Monte-Carlo error of a statistic read from
4000 draws, so the band of a statistic is its worst value over JAX's seeds
plus 3 of it; the band of rt is its worst value. Each band is printed with
the seeds' range. The last stdout line is one JSON object of all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import optax  # noqa: E402

from normalizingflow_tpu import (  # noqa: E402
    NormalizingFlow,
    bijectors,
    distributions,
)
from normalizingflow_tpu.targets import (  # noqa: E402
    Banana,
    CorrelatedGaussian,
)
from normalizingflow_tpu.train.objectives import forward_kl_loss  # noqa: E402
from tools.vi_moments import banana_cov, vi_stats  # noqa: E402

STEPS, BATCH, LR, DRAWS = 500, 256, 3e-3, 4000
MC_SETS = 200
TARGETS = {"correlated8": (4, lambda: CorrelatedGaussian(8, rho=0.6)),
           "correlated32": (16, lambda: CorrelatedGaussian()),
           "banana32": (16, lambda: Banana(32, b=0.1, s0=3.0))}
STATS = ("var_rel", "mean_sd", "corr_err")


def target_cov(target):
    if isinstance(target, Banana):
        return banana_cov(target.dim, target.b, target.s0)
    return np.asarray(target.cov, np.float64)


def exact_draws(target, n, rng):
    """n draws of the target's law from numpy's `rng`."""
    if isinstance(target, Banana):
        x = rng.standard_normal((n, target.dim))
        x[:, 0] *= target.s0
        x[:, 1] += target.b * (x[:, 0] ** 2 - target.s0 ** 2)
        return x
    return rng.standard_normal((n, target.dim)) @ np.linalg.cholesky(
        target_cov(target)).T


def fit(size, target, seed):
    dim = target.dim
    flow = NormalizingFlow(
        distributions.DiagNormal(dim),
        bijectors.Chain([
            bijectors.SplineCoupling(size=size, space_dim=2, num_bins=8,
                                     tail_bound=4.0, hidden_dim=32,
                                     mask=(0,)),
            bijectors.SplineCoupling(size=size, space_dim=2, num_bins=8,
                                     tail_bound=4.0, hidden_dim=32,
                                     mask=(1,)),
            bijectors.InvertibleLinear(dim),
        ]))
    params = flow.init(jax.random.PRNGKey(seed))
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, key):
        x = target.sample(key, BATCH)
        (loss, _), grads = jax.value_and_grad(
            lambda p: forward_kl_loss(flow, p, x), has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(STEPS):
        params, opt_state, loss = step(
            params, opt_state, jax.random.PRNGKey(2000 + 1000 * seed + i))
    x, _, z = flow.sample(params, jax.random.PRNGKey(9 + seed), DRAWS)
    z2, _, _ = flow.forward(params, x)
    return dict(seed=seed, final_loss=float(loss),
                rt=float(np.abs(np.asarray(z2) - np.asarray(z)).max()),
                **vi_stats(x, target_cov(target)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    result = {}
    for name, (size, make) in TARGETS.items():
        target = make()
        cov = target_cov(target)
        rng = np.random.default_rng(0)
        mc = [vi_stats(exact_draws(target, DRAWS, rng), cov)
              for _ in range(MC_SETS)]
        spread = {k: (float(np.mean([m[k] for m in mc])),
                      float(np.std([m[k] for m in mc]))) for k in STATS}
        runs = []
        for seed in range(args.seeds):
            runs.append(fit(size, target, seed))
            print(f"{name} seed {seed}: {json.dumps(runs[-1])}", flush=True)
        seeds = {k: (min(r[k] for r in runs), max(r[k] for r in runs))
                 for k in (*STATS, "rt")}
        band = {k: seeds[k][1] + 3 * spread[k][1] for k in STATS}
        band["rt"] = seeds["rt"][1]
        print(f"{name} exact draws (mean, sd) of each statistic: "
              f"{json.dumps(spread)}", flush=True)
        print(f"{name} seeds (min, max): {json.dumps(seeds)}", flush=True)
        print(f"{name} band: {json.dumps(band)}", flush=True)
        result[name] = dict(runs=runs, exact=spread, seeds=seeds, band=band)
    line = json.dumps(dict(jax=jax.__version__, steps=STEPS, batch=BATCH,
                           lr=LR, draws=DRAWS, targets=result))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
