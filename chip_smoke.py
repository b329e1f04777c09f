#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (normalizingflow_tpu_torch) on one GPU.

    python3 chip_smoke.py           # funnel line at reduced depth, spline
                                    # line at the bench's depth
    python3 chip_smoke.py --full    # the funnel line at the bench's depth
                                    # too: 15000 train steps, 1024 draws,
                                    # and 256 NUTS draws

Phases, each printing its own line; any failure exits non-zero:
  1. device : the card's name and power limit from nvidia-smi;
  2. build  : compiles every CUDA kernel from csrc/ with nvcc, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and beyond, with NaN/inf rows; times
              with CUDA events beside the plain version and the byte bound.
              The accept kernel is held in both its forms: the transition's
              fused tail (last half-kick, both kinetic energies, accept,
              select), in place and into fresh outputs, at about 0.47 and
              0.81 accepts, and the unfused accept/select of the JAX API.
              The RQS backward kernel is held against the closed-form plain
              VJP in float64, beside the float32 autograd recompute of the
              twin that it replaced (its error and time are printed too);
  4. main   : the bench's funnel line at full width -- RealNVP (ActNorm +
              2 x AffineCoupling, hidden 128) on NealsFunnel(64), reverse-KL
              training at batch 4096 (REDUCED_TRAIN_STEPS steps, the bench's
              15000 with --full), NeuTra-HMC with 8192 chains, warmup
              100, L=8, push to data space, bulk and tail ESS -- with the
              kernels' launch counts, and checks of the funnel's statistics;
  5. spline : the bench's spline line at full width and depth -- 3 x
              SplineCoupling (32 particles x 3, 32 bins, B = 6, hidden 354)
              on NealsFunnel(96), 2250 reverse-KL steps at batch 1024,
              NeuTra-HMC with 4096 chains, warmup 100, 256 draws, L=8 --
              with exact launch counts of the three kernels (the RQS
              forward and backward, accept/select), each layer's RQS
              kernels held against their plain versions on the trained
              flow, a round trip, the training's progress, and HMC moving
              var(v) from the flow's toward the funnel's 9; the band
              |v_mean| < 0.5, |v_var - 9| < 3 is reported, not enforced
              (this configuration misses it: ROADMAP Queue 3);
  6. fe_lj  : the free-energy pipeline on configs/LJ.yaml at its full width
              (NSF_AR, 2 x SplineAR(96, 32 bins, hidden 354,
              periodic), EinsteinCrystal prior, alpha 1000), through the
              port's CLI mains on a copy of the config whose paths point
              into a temporary directory: apps.sample_data (2000 frames,
              acceptance, finite and in the box), apps.train (LJ_EPOCHS,
              cut from the config's 8000; the last chunk's mean log-prob above the first's), apps.test
              (fe_diff with relaxation at 500 samples: four finite
              estimates and finite relaxed frames; emus, MBAR capped at
              its 500 iterations, is reported beside MBAR at 5000 and
              50000 and must approach bar, and bar must be MBAR's fixed
              point to 0.05) and apps.fe testing (2000 samples); the
              training's checkpoint time; exact launch counts of every
              kernel at each step; each trained layer's RQS kernels against
              the float64 plain versions, and a round trip; bar within
              0.36 of the JAX record 9.5778 (a fault detector at the cut
              depth, not a hold on its bias); then, on the trained flow and
              its 400 held-out frames, tools/torch_lj_permutation.py's
              diagnose (phase 15);
  7. fe_einstein: configs/Einstein.yaml, whose exact answer is 0:
              apps.train (its 8000 epochs cut to EINSTEIN_EPOCHS, on the
              analytic target's samples), then apps.test: |bar| <= 0.05,
              |emus - bar| <= 0.01, md and nf within 0.05 of bar; exact
              launch counts.
  8. fe_fe400k: configs/Fe_400K.yaml at full width (54 iron atoms, the
              tabulated EAM of data/fe_fs.setfl; 2 x SplineAR(162, 32 bins,
              hidden 354)) through the same CLI mains as fe_lj:
              sample_data 10000 frames (the JAX record's count), train
              (FE_EPOCHS, cut from the config's 15000), test with
              relaxation, fe testing; acceptance, frames in the box,
              training progress, finite relaxed frames and estimates, MBAR
              converged within 0.01 of bar, the trained layers' kernels;
              bar within 0.05 of the JAX record's -4.0839;
  9. fe_phi4: configs/Phi4.yaml: sample_data 10000 frames, train (its
              4000 forward-KL epochs cut to PHI4_EPOCHS, then the reverse-KL
              fine-tune, its 2000 steps cut to PHI4_RKL_STEPS, timed apart),
              test: finite estimates, |emus - bar| <= 0.01, bar within 0.05
              of the JAX record's -1.0594;
 10. polymer: configs/Polymer.yaml at full width (2048-d fields, 2 x
              SplineAR hidden 100, ~0.92B params): apps.polymer data (10000
              GFF fields on the card; mean action within 1% of dim/2),
              training (POLYMER_EPOCHS, cut from 15000), testing (sampling
              latency first and hot, held-out log-density, the gap to the
              exact GFF log-density); each trained layer's RQS kernels
              against the float64 plain versions on 100 held-out fields
              (the inverse through the 2048 sequential columns), and a
              round trip;
 11. polymer_rnvp: configs/Polymer_rnvp.yaml at full width (10 x
              AffineCoupling hidden 4000, ~0.97B params): apps.polymer
              training for RNVP_STEPS forward-KL steps on the polymer
              fields, checkpoints included, and the Adam first-moment dtype
              it reports against the memory policy's.
NUTS and SMC (mcmc/nuts.py, mcmc/smc.py) run inside phases 4 and 9:
  4b. nuts_funnel: NUTS on the funnel flow that phase 4 trained, bench.py
              nuts_ess_line's protocol at its width (4096 chains, max depth
              7): adaptation (warmup 100), then a timed run of NUTS_DRAWS
              draws (the bench's 256 with --full) and the push; accept,
              depth, divergence, ESS, gradient calls and n_leapfrog a
              transition; gates: accept in [0.6, 0.95], divergence < 0.01,
              the funnel's v band, and no kernel launched;
  4c. bench : the port's bench entry points (normalizingflow_tpu_torch/
              bench.py, bench_scaling.py) on phase 4's flow, bench.py's
              timed protocol (adaptation, a warm call, three timed runs of
              the draws and the push, the fastest kept): timed_sampling at
              BENCH_DRAWS, the Gaussian line (training cut to
              BENCH_GAUSS_STEPS), the NUTS line at BENCH_NUTS_DRAWS, the
              speed-of-light row, and bench_scaling.throughput at NCCL world
              size 1; gates: the line parses with every ported key present
              and finite, the funnel's accept and v band, ESS within its
              cap, exact launch counts (padded_length(draws) in each timed
              run), mfu_vs_fp32_peak in (0, 1];
  4d. nuts_eight_schools: the Stan/posteriordb eight-schools check of
              tests/test_nuts_smc.py in float32 (48 chains, 800 + 800,
              max depth 8), with its bands;
  9b. smc_phi4: flow-proposal SMC on the flow fe_phi4 trained, at
              tools/phi4_smc.py's width (8192 particles, 4 mutation steps
              of L = 8, step 0.1), 3 seeds: each dF/particle within 0.02
              of the JAX record -1.0565, exact launch counts of all three
              kernels, and the gap to the port's bar on the same flow.
The multi-device layer (parallel/) and the last modules run after them:
 12. parallel: the sharded paths on the flows that phases 4 and 9 trained.
              First NCCL at world size 1 in this process (a file:// store),
              then two gloo ranks on the one card (NCCL refuses two ranks
              on one GPU), spawned with the kernels already built. Each
              runs run_smc_sharded on the Phi4 flow (smc_phi4's width,
              8192 particles, its proposal sampled 4096 rows a call),
              make_sharded_train_step (20 steps at Phi4's batch of 100) and
              run_hmc_sharded on the funnel pullback (8192 chains: 16 + 20
              transitions held chain by chain to the unsharded run, then
              warmup 100 + 128 draws under the funnel's gates), every rank
              on its rows of one global input and draw stream. Gates (see
              par_compare): exact launch counts, results identical on every
              rank, SMC's stages and log Z and the parameters against the
              unsharded runs, dF/particle within 0.02 of the JAX record.
              Then utils.profiling.trace around two funnel transitions (the
              trace names the accept kernel and the matmuls), and Planar,
              Radial and OneByOneConv trained on Gaussian_rnvp.yaml (loss
              decreasing; Radial and OneByOneConv round-trip).
 13. jax_resume: a training run of the JAX package continued on the card.
              configs/Gaussian_rnvp.yaml uncut (RealNVP, 2 layers, hidden
              80, 40-d, batch 60): the JAX package's training state at
              epoch 2000 (tests/data/jax_gaussian_rnvp.msgpack.last, from
              tools/jax_resume_fixture.py: params, optax's Adam state, key,
              epoch, losses) copied into a temporary model_dir as
              `{name}.msgpack.last`; apps.train --resume continues it to
              the config's 3000 epochs, then apps.test, with no
              --checkpoint, evaluates the port's resumed `.pt`. Gates: the
              resume names the `.msgpack.last` and epoch 2000; the losses
              are the fixture's followed by the new chunks'; the first new
              chunk's mean log-prob within RESUME_GAP nats of the fixture's
              last; `.pt` and `.pt.last` written; four finite estimates,
              |bar| <= 0.05 and |emus - bar| <= 0.01 (exact answer 0); no
              kernel launched (a RealNVP flow and its apps.test launch
              none).
 14. parity : the full-depth campaign's tool (tools/torch_parity.py) in
              this process: run_config on configs/Gaussian.yaml (NSF_AR, 1
              layer, 40-d; exact answer 0) with its in-process runner, on a
              campaign root in a temporary directory: apps.train
              (PARITY_EPOCHS, cut from 3000), apps.fe testing, apps.test.
              Gates: the tool's status_of reads "ok" (held-out gap within
              0.05 a particle, every estimator near 0), |bar| <= 0.05, and
              exact launch counts, the row's own and this process's (both
              RQS kernels; no HMC, so no accept launch); the trained
              layer's RQS kernels (K = 10) against the float64 plain
              versions on 2000 target draws, forward, inverse and VJP, and
              a round trip.
 15. fit_studies: the fit-quality studies' tools in this process.
              tools/torch_fit_sweep.py's run_variant runs the `rkl` variant
              on configs/Gaussian.yaml (FIT_EPOCHS, cut from 3000, then
              FIT_RKL_STEPS reverse-KL steps, cut from 2000) and its
              held-out gap against 2000 target draws: |gap| <= 0.05 a
              particle. tools/torch_gm_fit_sweep.py's run of `ref` (the
              reference's 1 layer, GM_EPOCHS of its 2000 epochs): |nf| <=
              0.05. The permutation diagnostic of phase 6 on LJ: mean U of
              the raw and relabeled frames within 1e-3; the recovered share
              of the gap is printed. Exact launch counts in each of the
              three (both RQS kernels; no HMC).
 16. per_point: the JAX package's per-point target convention, run right
              after phase 5 on the flows phases 4 and 5 trained.
              pullback_logprob (one point) through pointwise_lp_grad
              (torch.func.vmap of grad_and_value) against the batched
              pullback: value and gradient at 8192 funnel chains (relative
              1e-5) and 4096 spline chains (1e-4); PP_TRANSITIONS
              transitions of hmc_kernel_batched against
              hmc_kernel_chainbatched on one draw stream, the first held
              chain by chain (positions within 1e-4, decisions equal away
              from the accept threshold); run_hmc(batched_target=False)
              for PP_WARMUP + PP_DRAWS, accept in [0.6, 0.95]; exact
              launches: one accept launch a transition and, on the spline
              flow, one RQS forward and one VJP launch a layer a gradient
              evaluation, as batched (the RQS Function's vmap rules stack
              the chains' rows into one call). PP_NUTS NUTS transitions
              through nuts_kernel against nuts_transition on the funnel
              pullback (depth 7, one tree's draws; no kernel launched).
              tests/test_nuts_smc.py's standard-normal target: the default
              raises ValueError, run_nuts(batched_target=False) within its
              bands. Per-point and batched ms a transition are printed.
 17. vi     : variational inference, BASELINE configs 2 and 3 as
              tests/test_vi.py defines them, right after phase 12's
              elementary flows, with its fit loop (Adam at a constant rate,
              256 fresh draws a step) at its depths. Config 2: 8 x
              Invert(Planar(2)) on CorrelatedGaussian(2, 0.7), 800 ELBO
              steps (loss drop >= 0.2, covariance of 8000 draws within
              0.25); 6 x Radial(2) on the one-centre GaussianMixture, 600
              steps (mean within 0.2); ELBO <= 0.05 for ActNorm(3) on a
              normalised target at 20000 draws; elbo == -reverse_kl on one
              latent batch; no kernel launched. Config 3: 2 x
              SplineCoupling (K 8, B 4, hidden 32) + InvertibleLinear, 500
              forward-KL steps, then 4000 draws (round trip within 1e-3):
              on CorrelatedGaussian(8, 0.6) with the JAX test's moment
              gates, and at size 16 on CorrelatedGaussian() (32, 0.9) and
              Banana(32) with the bands the JAX package's own flow meets at
              the same settings (VI_BANDS). Exact launches of both RQS
              kernels (K = 8, B = 4; their shapes are in PATH_RQS); ms a
              step of each fit; the device idle share of an ELBO and of a
              forward-KL step.
 18. circular: the RQS kernels' circular mode (csrc/rqs.cu's
              rqs_circular_fwd and rqs_circular_vjp, the splines of
              bijectors/transformer.py), run right after phase 3: forward
              and inverse against the circular plain version and the VJP
              against its closed-form plain VJP, all in float64, on rows
              inside the box (NaN rows too, and rows on both ends and on
              knots) at CRQS_SHAPES, the lj500_nsf_tcl layer's (64000, 16)
              and a small one; the kernel's VJP no further from float64
              than the float32 autograd recompute; a round trip where the
              slope lies in [0.1, 10]; the ends
              -L/2 and L/2 mapped to one point of the circle with one
              slope; ms of each beside the plain versions and its bound
              (bytes at 3.35 TB/s on the run's data). Then the main
              path: NSF_TCL at lj500_nsf_tcl's widths and depth through
              config.setup_model, a reverse-KL train_step with
              bench_optimizer, flow.sample and flow.log_prob (8 draws
              each), with exact launch counts (one circular forward a
              layer each way, one VJP a layer in the backward, no other
              kernel); crqs and crqs_vjp in the kernels line.
Every depth cut is printed on a line of its own. Then one JSON line
describing every kernel, and last the JSON status line. Imports nothing of
JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from normalizingflow_tpu_torch.ops import launch_counts, reset_launch_counts

# Published peaks of one H100 SXM (NVIDIA data sheet), used for bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DIM, HIDDEN, LAYERS = 64, 128, 2
CHAINS, WARMUP, LEAPFROG = 8192, 100, 8
TRAIN_BATCH = 4096
FULL_TRAIN_STEPS, FULL_DRAWS = 15000, 1024  # bench.py's depth
REDUCED_TRAIN_STEPS, REDUCED_DRAWS = 3000, 256
# (256, 96) and (8, 96): apps.sample_data's 256 chains and the HMC mixer's
# 8, at the LJ config's 96 coordinates; (256, 162) and (256, 64): the data
# chains of Fe_400K (162 is no multiple of 4: scalar loads, 3 units a lane)
# and of Phi4; (4096, 64): a rank's chains and particles in the parallel
# phase's two-rank run; (2048, 64): bench_scaling's chains at world size 1
KERNEL_SHAPES = [(8192, 64), (4096, 96), (1056, 64), (300, 2048), (96, 6),
                 (256, 96), (8, 96), (256, 162), (256, 64), (4096, 64),
                 (2048, 64)]
# accept kernel, checked too: rows wider than a block's registers (float
# loads, 1030 > 256 threads x 4 units), which stream their tail
WIDE_SHAPES = [(64, 1030)]

# The bench's spline line (bench.py spline_flow_lines), at its depth.
SP_SIZE, SP_SPACE, SP_BINS, SP_HIDDEN, SP_TAIL = 32, 3, 32, 354, 6.0
SP_DIM = SP_SIZE * SP_SPACE
SP_CHAINS, SP_DRAWS, SP_TRAIN_STEPS, SP_BATCH = 4096, 256, 2250, 1024
SP_PEAK_LR, SP_LR_WARMUP = 5e-4, 300

# RQS kernel checks: rows N, bins K, both directions, these bounds.
RQS_ROWS = [65536, 262144, 1000]
RQS_BINS = [8, 32, 64]
# the free-energy pipeline's forward shapes: integrate_out_v's one flat
# log_prob of 10 x 500 relaxed LJ frames (10 * 500 * 96 rows), and a
# training step of the LJ config (batch 40 x 96 coordinates)
FE_RQS_ROWS = [480000, 3840]
RQS_BOUNDS = {"sym": (-6.0, 6.0, -6.0, 6.0),
              "asym": (-1.5, 2.5, -0.5, 4.0)}
# The shapes slice 4's paths give the kernels, at their configs' bounds:
# (rows, bins, inverse, bounds); each check holds the forward and the VJP.
# Phi4's training batch (100 x 64) at K = 16 (the G = 4 instantiation),
# B = 6, both directions (its fine-tune inverts with a gradient); Fe_400K's
# integrate_out_v (10 x 500 x 162 rows) and training batch (50 x 162),
# B = 3 x 2.9115 / 2; Polymer's training batch (40 x 2048) and one column
# of its 100 draws' sequential inverse (apps.polymer testing), B = 4.
# smc_phi4's log_prob of 8192 particles x 64 sites and one column of its
# initial flow.sample; in the parallel phase's two-rank run, a rank's
# log_prob of 4096 particles, its training batch of 50 x 64 and one column
# of its 4096-row sample. The parity phase's Gaussian.yaml (K = 10, B = 4):
# its training batch (60 x 40), one column of a 500-draw batch's inverse
# and the log_prob of a 500-frame batch (500 x 40). The fit_studies
# phase's: a fine-tune step's column of 256 draws (Gaussian.yaml), the gm
# ref's training batch (40 x 40), its 2000 draws' column and their
# log_prob (2000 x 40); the permutation diagnostic's column of 400 LJ draws
# and its log_prob of 400 frames (400 x 96), B = (32 / 10.24)^(1/3); and
# the card studies' longest rows, the reverse-KL fine-tunes' columns of
# 256 draws on Phi4 and LJ. The vi phase's spline stacks (K = 8, B = 4,
# one transformed coordinate a particle): a training batch of 256 at the
# JAX test's 4 particles and at BASELINE's 16 (1024 and 4096 rows), and
# the 4000 draws' inverse and their round trip's forward (16000 and 64000
# rows).
PATH_BOUNDS = {"phi4": (-6.0, 6.0) * 2, "fe": (-4.36725, 4.36725) * 2,
               "polymer": (-4.0, 4.0) * 2, "gauss": (-4.0, 4.0) * 2,
               "lj": (-1.4620089, 1.4620089) * 2, "vi": (-4.0, 4.0) * 2}
PATH_RQS = [(6400, 16, False, "phi4"), (6400, 16, True, "phi4"),
            (810000, 32, False, "fe"), (8100, 32, False, "fe"),
            (81920, 32, False, "polymer"), (100, 32, True, "polymer"),
            (524288, 16, False, "phi4"), (8192, 16, True, "phi4"),
            (262144, 16, False, "phi4"), (3200, 16, False, "phi4"),
            (4096, 16, True, "phi4"), (2400, 10, False, "gauss"),
            (500, 10, True, "gauss"), (20000, 10, False, "gauss"),
            (256, 10, True, "gauss"), (1600, 10, False, "gauss"),
            (2000, 10, True, "gauss"), (80000, 10, False, "gauss"),
            (400, 32, True, "lj"), (38400, 32, False, "lj"),
            (256, 16, True, "phi4"), (256, 32, True, "lj"),
            (1024, 8, False, "vi"), (16000, 8, True, "vi"),
            (16000, 8, False, "vi"), (4096, 8, False, "vi"),
            (64000, 8, True, "vi"), (64000, 8, False, "vi")]
# tests/test_rqs_pallas.py's kernel-vs-jnp bar, kept for this kernel
RQS_Y_TOL = dict(atol=2e-5, rtol=1e-5)  # against the float64 plain version
RQS_LD_TOL = dict(atol=2e-4, rtol=1e-4)
# The backward kernel computes in float64 and rounds each gradient to
# float32 once (relative 6e-8), so it is held to the float64 plain VJP at
# rtol 1e-5; atol 1e-5 covers entries whose float64 terms cancel to ~0.
# It must also be no farther from the float64 VJP than the float32 autograd
# recompute of the twin, the backward it replaced.
RQS_GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
VJP_REPS = 20  # timing repetitions of the backward and its plain versions

# The free-energy phases: configs/LJ.yaml and configs/Einstein.yaml as
# shipped, driven through the port's CLI mains.
ROOT = Path(__file__).resolve().parent
FE_FRAMES = 2000              # apps.sample_data's default frame count
DATA_CHAINS, DATA_THIN, DATA_WARMUP = 256, 2, 500  # its HMC settings
TEST_SAMPLES, FE_SAMPLES, EVAL_BATCH = 500, 2000, 500  # apps.test, apps.fe
FE_CHECK_ROWS = 1024          # trained-layer kernel checks
# The JAX package's record of these configs (PARITY_RESULTS.md, TPU v5e):
# a reference printed beside the port's numbers, never a gate.
JAX_RECORD = {
    "Einstein": "bar -0.0001 md -0.0085 nf 0.0072 emus -0.0001 (exact 0)"}
# The JAX package's bar (runs/parity/results.json, TPU v5e) and the gate on
# the port's: Fe_400K and Phi4 (10000 frames) at 0.05, which the cut depths
# below meet with room (gaps of 0.0041 and 0.0027 measured on an H100). LJ
# (JAX: BAR over 3 data sets 9.5778 +- 0.1195) at three times that spread:
# a fault detector at LJ_EPOCHS, not a hold on the depth's bias (4000
# epochs read 9.819 on an H100, 0.241 off). A broken potential, log-det or
# estimator moves bar by far more; tools/torch_parity.py holds LJ at its
# 8000 epochs within 0.24 of the record.
BAR_GATE = 0.05
JAX_BAR = {"Fe_400K": (-4.083877, BAR_GATE), "Phi4": (-1.059406, BAR_GATE),
           "LJ": (9.577774, 0.36)}
# Depths cut so that the whole run stays near 650 s on one H100 on a slow
# host (the limit is 1200 s; the paths are host-bound and their seconds vary
# ~2x between hosts). Uncut, Phi4's reverse-KL fine-tune alone took 758 s
# (379 ms a step) and the run 1462 s. With LJ at its 8000 epochs the run
# took 1056 s on the slowest host seen (every host-bound phase ~1.5x a
# fast host's; LJ's training 128 s of it), so LJ is cut as well. Widths are
# never cut.
LJ_EPOCHS = 4000              # LJ.yaml: 8000
EINSTEIN_EPOCHS = 3000        # config: 8000
SLICE_FRAMES = 10000          # sample_data / apps.polymer data frames
FE_EPOCHS = 2500              # Fe_400K.yaml: 15000
PHI4_EPOCHS = 2000            # Phi4.yaml: 4000
PHI4_RKL_STEPS = 100          # Phi4.yaml: 2000
POLYMER_EPOCHS = 100          # Polymer.yaml: 15000
RNVP_STEPS = 20               # Polymer_rnvp.yaml: 15000
# NUTS on the funnel line's pullback at bench.py nuts_ess_line's width; its
# 256 draws are cut to 128 (--full runs 256)
NUTS_CHAINS, NUTS_MAX_DEPTH = 4096, 7
NUTS_DRAWS, FULL_NUTS_DRAWS = 128, 256
PROFILED = 3  # NUTS transitions, SMC stages, run under torch.profiler
# The bench phase (normalizingflow_tpu_torch/bench.py): its draws, the
# Gaussian line's training steps (the bench's: 15000; above the 500 of
# its learning-rate warmup), NUTS draws and the scaling run's draws. At
# 128, 1000, 64 and 128 the phase took 143 s on a slow host (68.6 ms a
# funnel transition) and the run 992 s of its 1200, hence these cuts.
BENCH_DRAWS, BENCH_GAUSS_STEPS = 64, 600
BENCH_NUTS_DRAWS, BENCH_SCALING_DRAWS = 32, 64
# The line's keys that the phase gates: bench.py's (bench.py:199-215 and
# the detail of :540-552, without the spline line), NUTS's (:269-282) and
# the speed-of-light row's with the port's float32 peak
BENCH_HMC_KEYS = ("ess_min_bulk_x", "ess_min_bulk_x2", "ess_median_bulk_x",
                  "ess_min_raw_x", "ess_min_raw_x2", "ess_tail_hardest_coord",
                  "ess_cap", "sample_s", "sample_s_all", "train_s",
                  "final_reverse_kl", "accept", "ess_per_s")
BENCH_FUNNEL_KEYS = BENCH_HMC_KEYS[:-1] + (
    "v_mean", "v_var", "chains", "draws", "leapfrog", "flow_layers",
    "fwd_logdet_us_batch8192", "fwd_logdet_gflop", "achieved_tflops",
    "mfu_vs_bf16_peak", "mfu_vs_fp32_peak", "sol_compute_us", "device",
    "power_limit_w")
BENCH_NUTS_KEYS = ("ess_per_s", "ess_min_bulk_x", "ess_min_bulk_x2",
                   "ess_cap", "sample_s", "sample_s_all", "mean_tree_depth",
                   "divergence_rate", "accept", "chains", "draws",
                   "max_depth")
# Flow-proposal SMC on the trained Phi4 flow at tools/phi4_smc.py's width:
# particles, mutation steps, leapfrog steps, step size, seeds
SMC_PARTICLES, SMC_MUTATIONS, SMC_LEAPFROG, SMC_STEP = 8192, 4, 8, 0.1
SMC_SEEDS = 3
# The JAX package's SMC dF/particle on Phi4 (PARITY_RESULTS.md, TPU v5e,
# 3 seeds: -1.0565 +- 0.0013); each seed's must lie within SMC_GATE
JAX_SMC_DF, SMC_GATE = -1.0565, 0.02
# The parallel phase (parallel/ on torch.distributed): NCCL at world size
# 1, then PAR_WORLD gloo ranks on the one card. SMC on the trained Phi4
# flow at smc_phi4's width, its proposal sampled in blocks of PAR_BLOCK
# rows (a rank's share at two ranks); PAR_TRAIN_STEPS training steps at
# Phi4's batch; the funnel pullback at CHAINS chains: a short run
# (PAR_SHORT warmup and draws) held chain by chain to the unsharded run,
# then WARMUP + PAR_HMC_DRAWS under the funnel's gates.
PAR_WORLD, PAR_BLOCK, PAR_TRAIN_STEPS, PAR_BATCH = 2, 4096, 20, 100
PAR_SHORT, PAR_HMC_DRAWS = (16, 20), 128
# Gates against the unsharded runs. In float32 one ulp anywhere grows: a
# chain mean summed in another order than torch.mean's moves the step
# size, accept tests at the threshold flip, SMC's tempering follows other
# particles (on a CPU rehearsal, where a matmul rounds a row by the batch
# it is in, two ranks parted from one by a stage and 2% in log Z). So the
# references sum each chain mean over the ranks' blocks of rows in rank
# order (PartsMesh), the proposal is sampled in the ranks' blocks, and the
# training reference sums the gradient over the ranks' halves, as the
# all-reduce does: Adam's first update is +-lr whatever the gradient's
# size, so a whole-batch reference parts by ~lr on every near-zero
# gradient entry (20 steps on the CPU: 0.0045). The plain torch.mean SMC
# run is reported beside.
PAR_LOGZ_RTOL, PAR_HMC_RTOL, PAR_PARAM_TOL = 1e-5, 1e-5, 1e-5
PAR_CHAIN_TOL, PAR_CHAIN_SHARE = 1e-3, 1e-3
# Planar, Radial and OneByOneConv (InvertibleLinear) on Gaussian_rnvp.yaml:
# two training chunks of 500
ELEMENTARY = ("Planar", "Radial", "OneByOneConv")
ELEMENTARY_EPOCHS = 1000
# The jax_resume phase: the JAX package's training state of
# Gaussian_rnvp.yaml at epoch JAX_EPOCH, resumed uncut. A fresh flow's first
# chunk lies tens of nats below a trained one's, so a resume that lost the
# params or the optimizer's state shows against RESUME_GAP.
JAX_FIXTURE = ROOT / "tests" / "data" / "jax_gaussian_rnvp.msgpack.last"
JAX_EPOCH, RESUME_GAP = 2000, 1.0
# The parity phase: configs/Gaussian.yaml's 3000 epochs cut to 500. On an
# H100 (tools/torch_parity_depth.py) status_of read "ok" at each of 250,
# 500, 750, 1000 and 1500 epochs, but at 250 with a held-out gap of 0.047
# a particle against its 0.05 and md -0.125 against 0.15; at 500 the gap
# was 0.013 and md -0.094, so 500 is the fewest that meets the gates with
# room. The phase took 2.8 s there.
PARITY_EPOCHS = 500
# The fit_studies phase: the `rkl` variant on configs/Gaussian.yaml at the
# parity phase's tested depth (500 of 3000 epochs) and 50 of its 2000
# reverse-KL steps (a step pushes 256 draws through the 40-d SplineAR
# inverse); GaussianMixture's `ref` at 1000 of 2000 epochs. The phase took
# 8.8 s on an H100.
FIT_EPOCHS, FIT_RKL_STEPS, GM_EPOCHS = 500, 50, 1000
ENERGY_TOL = 1e-3  # relabeling permutes atoms: U must not move
# The per_point phase (16) on the flows of phases 4 and 5 at their widths:
# PP_TRANSITIONS transitions per point against batched on one draw stream,
# then run_hmc(batched_target=False) for PP_WARMUP + PP_DRAWS; PP_NUTS NUTS
# transitions at NUTS_MAX_DEPTH; JAX's standard-normal NUTS test
# (tests/test_nuts_smc.py: 32 chains, 300 + 500 draws) at PP_NORMAL_CHAINS
# chains and PP_NORMAL_WARMUP + PP_NORMAL_DRAWS. Per point and batched run
# the same kernels on the same rows; the conditioners' matmuls may round
# apart in float32 (PP_RTOL, relative to each tensor's scale). A first
# transition's decisions may differ only within PP_POS_TOL of the accept
# threshold, and its positions agree to PP_POS_TOL elsewhere.
PP_TRANSITIONS, PP_WARMUP, PP_DRAWS, PP_NUTS = 16, 50, 32, 4
PP_NORMAL_CHAINS, PP_NORMAL_WARMUP, PP_NORMAL_DRAWS = 1024, 100, 64
PP_RTOL = {"funnel": 1e-5, "spline": 1e-4}
PP_POS_TOL, PP_NUTS_AGREE = 1e-4, 0.99
# The vi phase (17): tests/test_vi.py's fit loop (Adam at a constant rate,
# VI_DRAWS fresh draws a step) at its own depths, none cut: Planar and
# Radial stacks by ELBO (BASELINE config 2), the spline + InvertibleLinear
# stack by forward KL (config 3) at the JAX test's 8-d and at BASELINE's
# 32-d (size 16). JAX's bands at 8-d: its test's own. At 32-d: what the JAX
# package's flow meets on the CPU at the same settings
# (tools/jax_vi_bands.py, float32, 8 seeds): each statistic's worst seed
# plus 3 times its Monte-Carlo error at VI_SAMPLES exact target draws,
# rounded up in the third decimal.
VI_DRAWS, VI_LR, VI_SPLINE_LR = 256, 5e-3, 3e-3
VI_PLANAR_STEPS, VI_RADIAL_STEPS, VI_SPLINE_STEPS = 800, 600, 500
VI_COV_DRAWS, VI_ELBO_DRAWS, VI_SAMPLES = 8000, 20000, 4000
VI_RT_TOL = 1e-3      # the JAX test's round trip
VI_PROFILED = 5       # steps of each objective under torch.profiler
VI_BANDS = {"correlated32": dict(var_rel=0.279, mean_sd=0.116,
                                 corr_err=0.050),
            "banana32": dict(var_rel=0.142, mean_sd=0.118, corr_err=0.023)}


def log(*a):
    print(*a, flush=True)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=50, flush=None, prepare=None):
    """Median per-call device time (CUDA events around each call).

    Before each call the device spins for about half a millisecond, so the
    host has queued the whole call before its start event fires and the
    time is the device's, not the host's launch overhead. `flush` (a large
    buffer) is overwritten before each call, outside the timed region, so
    the call finds its inputs in HBM and not in L2. `prepare` runs before
    each call (and before the flush), outside the timed region: it restores
    what an in-place call changed."""
    for _ in range(5):
        if prepare is not None:
            prepare()
        fn()
    pairs = []
    for _ in range(reps):
        if prepare is not None:
            prepare()
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ------------------------------------------------------------ accept/select
def accept_inputs(n, d, gen):
    """Random chain state with mixed accepts and divergent rows.

    h_old is set around h_new so that dE ~ N(0, 1) and about half the rows
    accept. Rows 0::7 have a NaN lp_new, rows 1::7 a NaN q and an inf
    momentum, rows 2::7 a NaN h_old: all must be rejected, with
    accept_prob 0 where h_new is not finite.
    """
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    q, p, g_new, pos_old, g_old = (torch.randn(n, d, **kw) for _ in range(5))
    lp_new, lp_old = torch.randn(n, **kw), torch.randn(n, **kw)
    inv_m = torch.exp(0.3 * torch.randn(d, **kw))
    kin = 0.5 * torch.sum(inv_m.double() * p.double() ** 2, dim=1)
    h_old = (-lp_new.double() + kin + torch.randn(n, **kw).double()).float()
    log_u = torch.log(torch.rand(n, **kw))
    lp_new[0::7] = float("nan")
    q[1::7] = float("nan")
    p[1::7, 0] = float("inf")
    h_old[2::7] = float("nan")
    return q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_m


def accept_bound(args, accepted):
    """Least time for this data: p, the selected position and gradient
    rows, the per-row scalars (lp_old only where rejected) and inv_mass
    read once; the outputs written once."""
    q, p, *_, inv_m = args
    n, d = q.shape
    rejected = int((~accepted).sum())
    read = 4 * (3 * n * d + 3 * n + rejected + d)
    write = 4 * (2 * n * d + 3 * n) + n
    ops = 3 * n * d + 10 * n
    t_bytes = (read + write) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compare_accept(ker, ref, scale, log_u, label):
    """Kernel outputs against the plain version's. The kernel sums the
    kinetic energies in another order than torch.sum, so dE may differ by a
    few f32 ulps of the terms it is made of (`scale`, per row): the
    tolerance is relative to them. A row whose accept test lies within that
    of log_u may flip; it is excluded from the exact checks and counted.
    Returns (max_abs_err, rows excluded, tol)."""
    pos_r, lp_r, g_r, ap_r, acc_r, de_r = ref
    pos_k, lp_k, g_k, ap_k, acc_k, de_k = ker
    tol = 1e-5 * torch.clamp(scale.nan_to_num(0.0, 0.0, 0.0), min=1.0)
    log_acc = torch.clamp(de_r, max=0.0)
    near = (log_u - log_acc).abs() < tol
    keep = ~near
    exact = dict(pos=(pos_k, pos_r), g=(g_k, g_r), lp=(lp_k, lp_r),
                 accepted=(acc_k, acc_r))
    for name, (a, b) in exact.items():
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0,
                                   equal_nan=True, msg=f"{name} {label}")
    finite = torch.isfinite(de_r)
    if not torch.equal(finite, torch.isfinite(de_k)):
        raise AssertionError(f"d_energy finiteness differs {label}")
    de_err = (de_k - de_r).abs()[finite]
    if bool((de_err > tol[finite]).any()):
        raise AssertionError(f"d_energy off by {float(de_err.max())} "
                             f"{label}")
    ap_err = (ap_k - ap_r).abs()
    if bool((ap_err > 1e-5 + tol * ap_r).any()):
        raise AssertionError(f"accept_prob off by {float(ap_err.max())} "
                             f"{label}")
    n_acc = int(acc_r.sum())
    if not 0 < n_acc < acc_r.numel():
        raise AssertionError(f"inputs gave no mixed accepts {label}")
    max_err = max(float(de_err.max()), float(ap_err.max()),
                  float((pos_k - pos_r)[keep].abs().nan_to_num(0.0).max()),
                  float((g_k - g_r)[keep].abs().nan_to_num(0.0).max()))
    return max_err, int(near.sum())


def check_accept_select(n, d, gen, flush):
    """The kernel's unfused form (accept_select) against accept_select_ref
    at accept_inputs."""
    from normalizingflow_tpu_torch.ops.hmc import (
        accept_select,
        accept_select_ref,
    )

    args = accept_inputs(n, d, gen)
    q, p, g_new, pos_old, g_old, lp_new, lp_old, h_old, log_u, inv_m = args
    ref = accept_select_ref(*args)
    ker = accept_select(*args)  # CUDA tensors: the kernel
    torch.cuda.synchronize()
    kin = 0.5 * torch.sum(inv_m * p * p, dim=1)
    max_err, n_near = compare_accept(
        ker, ref, h_old.abs() + lp_new.abs() + kin, log_u,
        f"unfused ({n},{d})")

    ms = cuda_time_ms(lambda: accept_select(*args), flush=flush)
    plain_ms = cuda_time_ms(lambda: accept_select_ref(*args), flush=flush)
    bound_ms, bound_by = accept_bound(args, ref[4])
    log(f"kernels: accept_select unfused ({n},{d}) f32 ok: accepted "
        f"{int(ref[4].sum())}/{n}, excluded near-threshold {n_near}, "
        f"max_abs_err {max_err:.3g}, ms {ms:.5f}, plain_ms {plain_ms:.5f}, "
        f"bound_ms {bound_ms:.5f} ({bound_by}), share of bound "
        f"{bound_ms / ms:.3f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# accept settings of the fused checks: dE ~ N(shift, 1) around the
# proposal, and every `every`-th row of each kind of divergence
ACCEPT_MIXES = {"half": dict(shift=0.0, every=7),
                "main": dict(shift=0.3, every=101)}


def fused_inputs(n, d, gen, shift, every):
    """Random inputs of accept_select_fused: (q, p_half, eps (n, 1), g_new,
    momentum0, state_pos, state_grad, state_lp, lp_new, log_u, inv_m).

    state_lp is set so that h_old - h_new ~ N(shift, 1): about 0.47 of the
    rows accept with shift 0 and every 7, about 0.81 with shift 0.3 and
    every 101. Rows 0::every have a NaN lp_new, rows 1::every a NaN q and
    an inf p_half, rows 2::every a NaN state_lp (all rejected; accept_prob
    0 where h_new is not finite), rows 3::every an inf momentum (h_old =
    inf: accepted)."""
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    q, p_half, g_new, mom, pos, grad = (torch.randn(n, d, **kw)
                                        for _ in range(6))
    inv_m = torch.exp(0.3 * torch.randn(d, **kw))
    mom = torch.sqrt(1.0 / inv_m) * mom
    eps = 0.1 * (1.0 + 0.2 * (2.0 * torch.rand(n, 1, **kw) - 1.0))
    lp_new = torch.randn(n, **kw)
    p = p_half + 0.5 * eps * g_new
    h_new = -lp_new.double() + 0.5 * torch.sum(
        inv_m.double() * p.double() ** 2, dim=1)
    kin_old = 0.5 * torch.sum(inv_m.double() * mom.double() ** 2, dim=1)
    h_old = h_new + shift + torch.randn(n, **kw).double()
    state_lp = (kin_old - h_old).float()
    log_u = torch.log(torch.rand(n, **kw))
    lp_new[0::every] = float("nan")
    q[1::every] = float("nan")
    p_half[1::every, 0] = float("inf")
    state_lp[2::every] = float("nan")
    mom[3::every, 0] = float("inf")
    return q, p_half, eps, g_new, mom, pos, grad, state_lp, lp_new, log_u, \
        inv_m


def fused_bound(args, accepted, inplace):
    """Least time of accept_select_fused on this data: momentum0, p_half
    and g_new rows, q rows of accepted chains, four scalars a row and
    inv_mass read once; pos and grad rows and lp of accepted chains, and
    accept_prob, accepted and dE written once. Fresh outputs add the
    rejected chains' old rows, read and written, and their lp."""
    n, d = args[0].shape
    acc = int(accepted.sum())
    rej = n - acc
    read = 4 * (3 * n * d + acc * d + 4 * n + d)
    write = 4 * (2 * acc * d + acc + 2 * n) + n
    if not inplace:
        read += 4 * 2 * rej * d
        write += 4 * (2 * rej * d + rej)
    ops = 8 * n * d + 20 * n
    t_bytes = (read + write) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_accept_fused(n, d, mix, gen, flush):
    """The fused kernel, in place and into fresh outputs, against
    accept_select_fused_ref; rows it rejects in place must be left as they
    were. Timed in place (the main path's form), beside the fresh form, the
    plain version and the unfused path (the half-kick and h_old by torch,
    then the unfused kernel)."""
    from normalizingflow_tpu_torch.ops.hmc import (
        accept_select,
        accept_select_fused,
        accept_select_fused_ref,
    )

    args = fused_inputs(n, d, gen, **ACCEPT_MIXES[mix])
    q, p_half, eps, g_new, mom, pos, grad, state_lp, lp_new, log_u, inv_m = \
        args
    label = f"fused ({n},{d}) {mix}"
    ref = accept_select_fused_ref(*args)
    p = p_half + 0.5 * eps * g_new
    scale = (state_lp.abs() + lp_new.abs()
             + 0.5 * torch.sum(inv_m * (p * p + mom * mom), dim=1))

    fresh = accept_select_fused(*args)  # CUDA tensors: the kernel
    work = [t.clone() for t in (pos, grad, state_lp)]
    ker = accept_select_fused(*args[:5], *work, *args[8:], inplace=True)
    torch.cuda.synchronize()
    if not all(a is b for a, b in zip((ker[0], ker[2], ker[1]), work)):
        raise AssertionError(f"in place did not return the state {label}")
    err_fresh, near = compare_accept(fresh, ref, scale, log_u,
                                     label + " fresh")
    err_inplace, _ = compare_accept(ker, ref, scale, log_u,
                                    label + " in place")
    rejected = ~ker[4]
    for now, old in zip(work, (pos, grad, state_lp)):
        torch.testing.assert_close(now[rejected], old[rejected], rtol=0,
                                   atol=0, equal_nan=True,
                                   msg=f"a rejected row changed {label}")

    def restore():
        for w, t in zip(work, (pos, grad, state_lp)):
            w.copy_(t)

    def in_place():
        accept_select_fused(*args[:5], *work, *args[8:], inplace=True)

    def unfused_path():
        h_old = -state_lp + 0.5 * torch.sum(inv_m * mom * mom, dim=-1)
        accept_select(q, p_half + 0.5 * eps * g_new, g_new, pos, grad,
                      lp_new, state_lp, h_old, log_u, inv_m)

    ms = cuda_time_ms(in_place, flush=flush, prepare=restore)
    ms_warm = cuda_time_ms(in_place, prepare=restore)
    fresh_ms = cuda_time_ms(lambda: accept_select_fused(*args), flush=flush)
    plain_ms = cuda_time_ms(lambda: accept_select_fused_ref(*args),
                            flush=flush)
    unfused_ms = cuda_time_ms(unfused_path, flush=flush)
    bound_ms, bound_by = fused_bound(args, ref[4], inplace=True)
    fresh_bound, _ = fused_bound(args, ref[4], inplace=False)
    max_err = max(err_fresh, err_inplace)
    log(f"kernels: accept_select fused ({n},{d}) {mix} f32 ok: accepted "
        f"{int(ref[4].sum())}/{n}, excluded near-threshold {near}, "
        f"max_abs_err {max_err:.3g}; in place ms {ms:.5f} (L2 warm "
        f"{ms_warm:.5f}), bound_ms {bound_ms:.5f} ({bound_by}), share of "
        f"bound {bound_ms / ms:.3f}; fresh ms {fresh_ms:.5f}, bound_ms "
        f"{fresh_bound:.5f}, share {fresh_bound / fresh_ms:.3f}; plain_ms "
        f"{plain_ms:.5f}; unfused path ms {unfused_ms:.5f}")
    return dict(max_abs_err=max_err, ms=ms, ms_warm=ms_warm,
                fresh_ms=fresh_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------------------- main path
def build_flow(gen, device):
    from normalizingflow_tpu_torch import NormalizingFlow
    from normalizingflow_tpu_torch.bijectors import (
        ActNorm,
        AffineCoupling,
        Chain,
    )
    from normalizingflow_tpu_torch.distributions import DiagNormal

    kw = dict(device=device, dtype=torch.float32)
    return NormalizingFlow(
        DiagNormal(DIM, **kw),
        Chain([ActNorm(DIM, **kw)] + [
            AffineCoupling(DIM, hidden_dim=HIDDEN, generator=gen, **kw)
            for _ in range(LAYERS)]))


def main_path(train_steps, draws, seed, device="cuda"):
    from normalizingflow_tpu_torch.estimators.ess import (
        bulk_ess_per_dim,
        tail_ess,
    )
    from normalizingflow_tpu_torch.mcmc import neutra_hmc, padded_length
    from normalizingflow_tpu_torch.ops.hmc import (
        accept_select,
        accept_select_fused,
    )
    from normalizingflow_tpu_torch.targets import NealsFunnel
    from normalizingflow_tpu_torch.train.loop import train

    gen = torch.Generator(device=device).manual_seed(seed)
    flow = build_flow(gen, device)
    target = NealsFunnel(DIM)

    accept_select.launches = 0
    accept_select_fused.launches = 0
    t0 = time.perf_counter()
    final_kl = train(flow, target, train_steps, TRAIN_BATCH, gen,
                     device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = neutra_hmc(gen, flow, target, CHAINS, draws, num_warmup=WARMUP,
                     step_size=0.5, num_leapfrog=LEAPFROG, device=device)
    end.record()
    torch.cuda.synchronize()
    launches = accept_select_fused.launches
    unfused = accept_select.launches
    sample_s = start.elapsed_time(end) / 1e3
    transitions = padded_length(WARMUP) + padded_length(draws)

    xs = res.samples_x
    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    ess_min = float(torch.minimum(bulk_x.min(), bulk_x2.min()))
    hardest = int(torch.argmin(bulk_x))
    ess_tail = float(tail_ess(xs[:, :, hardest]))
    v = xs[..., 0]
    accept = float(res.accept_rate)
    stats = dict(
        reduced=train_steps < FULL_TRAIN_STEPS or draws < FULL_DRAWS,
        train_steps=train_steps, train_s=train_s, final_reverse_kl=final_kl,
        chains=CHAINS, warmup=WARMUP, draws=draws, leapfrog=LEAPFROG,
        transitions=transitions, accept_launches=launches,
        accept_unfused_launches=unfused,
        accept=accept, step_size=float(res.step_size),
        v_mean=float(v.mean()), v_var=float(v.var(correction=0)),
        ess_min_bulk_x=float(bulk_x.min()),
        ess_min_bulk_x2=float(bulk_x2.min()), ess_min=ess_min,
        ess_tail_hardest_coord=ess_tail,
        sample_s=sample_s, ess_per_s_with_warmup=ess_min / sample_s,
        ms_per_transition=sample_s * 1e3 / transitions)
    log("main: " + json.dumps(stats))

    if launches != transitions or unfused != 0:
        raise AssertionError(f"the fused accept kernel launched {launches} "
                             f"times for {transitions} transitions, the "
                             f"unfused form {unfused} times")
    if not bool(torch.isfinite(xs).all()) or not all(
            math.isfinite(x) for x in (final_kl, ess_min, ess_tail, accept)):
        raise AssertionError("non-finite output")
    if xs.shape != (draws, CHAINS, DIM):
        raise AssertionError(f"samples shape {tuple(xs.shape)}")
    if not 0.6 <= accept <= 0.95:
        raise AssertionError(f"accept {accept} outside [0.6, 0.95]")
    if abs(stats["v_mean"]) >= 0.15 or abs(stats["v_var"] - 9.0) >= 0.9:
        raise AssertionError(
            f"funnel v stats off: mean {stats['v_mean']}, var "
            f"{stats['v_var']} (exact 0, 9)")
    return launches, flow, stats


# ------------------------------------------------------------------- nuts
def device_idle(fn):
    """fn() under torch.profiler: its wall ms (synchronised), the device's
    busy ms (the sum of its kernels' times), idle share 1 - busy / wall,
    kernel launches, and the five kernels that took the most device time.
    The profiler's own host cost is in the wall. A user annotation's range
    on the device (torch.optim's `Optimizer.step#...`) is no kernel and
    is left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and ev.device_time_total > 0
           and not getattr(ev, "is_user_annotation", False)]
    busy_ms = sum(ev.device_time_total for ev in dev) / 1e3
    dev.sort(key=lambda ev: -ev.device_time_total)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                launches=sum(ev.count for ev in dev),
                top=[dict(kernel=ev.key[:80], ms=ev.device_time_total / 1e3,
                          launches=ev.count) for ev in dev[:5]])


def no_kernel_moved(label, before):
    """Raise unless every kernel's launch count is what it was."""
    if launch_counts() != before:
        raise AssertionError(f"{label}: launches {before} -> "
                             f"{launch_counts()}; NUTS launches no kernel")


class TransitionLog:
    """Each NUTS transition's mean n_leapfrog (device scalars, read after
    the run), and the batched gradient calls of a log-prob it wraps."""

    def __init__(self, logprob):
        from normalizingflow_tpu_torch.mcmc import nuts

        self.module, self.real = nuts, nuts.nuts_transition
        self.logprob_fn, self.calls, self.leapfrogs = logprob, 0, []

    def logprob(self, x):
        self.calls += 1
        return self.logprob_fn(x)

    def _transition(self, *args, **kwargs):
        state, info = self.real(*args, **kwargs)
        self.leapfrogs.append(info.n_leapfrog.float().mean())
        return state, info

    def __enter__(self):
        self.module.nuts_transition = self._transition
        return self

    def __exit__(self, *exc):
        self.module.nuts_transition = self.real

    def per_transition(self, transitions):
        """(batched gradient calls, mean n_leapfrog) a transition; the
        first call is run_nuts' hmc_init."""
        return ((self.calls - 1) / transitions,
                float(torch.stack(self.leapfrogs).mean()))


def nuts_funnel(flow, draws, seed, device="cuda"):
    """NUTS on the funnel line's NeuTra pullback, bench.py's nuts_ess_line
    protocol: an adaptation run (warmup 100, 2 draws, step 0.5, max depth
    7, 4096 chains from prior draws), then a separately timed sampling run
    (no warmup, the adapted step and mass) with the push to data space.
    Gates: finite, accept in [0.6, 0.95], divergence < 0.01, the funnel's v
    band, and no kernel launched (NUTS selects by multinomial sampling, and
    the RealNVP flow has no spline)."""
    from normalizingflow_tpu_torch.estimators.ess import bulk_ess_per_dim
    from normalizingflow_tpu_torch.mcmc import (
        padded_length,
        pullback_logprob_batched,
        push_to_data,
        run_nuts,
    )
    from normalizingflow_tpu_torch.targets import NealsFunnel

    flow.requires_grad_(False)  # the gradient is taken in z only
    gen = torch.Generator(device=device).manual_seed(seed + 21)
    pullback = pullback_logprob_batched(flow, NealsFunnel(DIM))
    reset_launch_counts()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapt = run_nuts(gen, pullback, flow.prior.sample(NUTS_CHAINS,
                                                      generator=gen),
                     2, num_warmup=WARMUP, step_size=0.5,
                     max_depth=NUTS_MAX_DEPTH, device=device)
    torch.cuda.synchronize()
    adapt_s = time.perf_counter() - t0

    with TransitionLog(pullback) as tlog:
        t0 = time.perf_counter()
        res = run_nuts(gen, tlog.logprob, adapt.final_state.position, draws,
                       num_warmup=0, step_size=float(adapt.step_size),
                       max_depth=NUTS_MAX_DEPTH,
                       inv_mass_diag=adapt.inv_mass_diag, device=device)
        xs = push_to_data(flow, res.samples)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
    no_kernel_moved("nuts_funnel", before)
    transitions = padded_length(draws)
    grads, leapfrogs = tlog.per_transition(transitions)
    profiled = device_idle(lambda: run_nuts(
        gen, pullback, res.final_state.position, PROFILED, num_warmup=0,
        step_size=float(adapt.step_size), max_depth=NUTS_MAX_DEPTH,
        inv_mass_diag=adapt.inv_mass_diag, device=device))

    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    ess_min = float(torch.minimum(bulk_x.min(), bulk_x2.min()))
    v = xs[..., 0]
    stats = dict(
        chains=NUTS_CHAINS, warmup=WARMUP, draws=draws,
        max_depth=NUTS_MAX_DEPTH, adapt_s=adapt_s,
        step_size=float(adapt.step_size), accept=float(res.accept_rate),
        mean_depth=float(res.mean_depth),
        divergence_rate=float(res.divergence_rate),
        v_mean=float(v.mean()), v_var=float(v.var(correction=0)),
        ess_min_bulk_x=float(bulk_x.min()),
        ess_min_bulk_x2=float(bulk_x2.min()), ess_min=ess_min,
        sample_s=sample_s, ess_per_s=ess_min / sample_s,
        transitions=transitions,
        ms_per_transition=sample_s * 1e3 / transitions,
        gradient_calls_per_transition=grads,
        mean_n_leapfrog=leapfrogs,
        profiled=dict(transitions=PROFILED, **profiled),
        tpu_record=dict(accept=0.794, mean_depth=2.5, chains=4096,
                        max_depth=7))
    log("nuts_funnel: " + json.dumps(stats))
    if not bool(torch.isfinite(xs).all()) or not all(
            math.isfinite(x) for x in stats.values()
            if isinstance(x, float)):
        raise AssertionError("nuts_funnel: non-finite output")
    if not 0.6 <= stats["accept"] <= 0.95:
        raise AssertionError(f"nuts_funnel: accept {stats['accept']}")
    if not stats["divergence_rate"] < 0.01:
        raise AssertionError(
            f"nuts_funnel: divergence rate {stats['divergence_rate']}")
    if abs(stats["v_mean"]) >= 0.15 or abs(stats["v_var"] - 9.0) >= 0.9:
        raise AssertionError(
            f"nuts_funnel: v mean {stats['v_mean']}, var {stats['v_var']} "
            f"(exact 0, 9)")
    return launch_counts()


EIGHT_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
EIGHT_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def eight_schools_logprob(x):
    """Non-centered eight schools, batched: mu ~ N(0, 5), tau ~
    HalfCauchy(5) through log_tau with its Jacobian, z ~ N(0, 1)^8, y ~
    N(mu + tau * z, sigma)."""
    y = torch.tensor(EIGHT_Y, dtype=x.dtype, device=x.device)
    sig = torch.tensor(EIGHT_SIGMA, dtype=x.dtype, device=x.device)
    mu, log_tau, z = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    lp = -0.5 * (mu / 5.0) ** 2
    lp = lp + (math.log(2.0 / (math.pi * 5.0))
               - torch.log1p((tau / 5.0) ** 2) + log_tau)
    lp = lp - 0.5 * torch.sum(z * z, dim=-1)
    return lp + torch.sum(
        -0.5 * ((y - (mu[:, None] + tau[:, None] * z)) / sig) ** 2, dim=-1)


def nuts_eight_schools(seed, device="cuda"):
    """tests/test_nuts_smc.py's Stan/posteriordb check on the card in
    float32: 48 chains, 800 warmup + 800 draws, max depth 8, step 0.1, and
    its bands."""
    from normalizingflow_tpu_torch.mcmc import padded_length, run_nuts

    gen = torch.Generator(device=device).manual_seed(seed)
    init = 0.1 * torch.randn(48, 10, generator=gen, device=device)
    reset_launch_counts()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_nuts(gen, eight_schools_logprob, init, 800, num_warmup=800,
                   step_size=0.1, max_depth=8, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_kernel_moved("nuts_eight_schools", before)
    s = res.samples.reshape(-1, 10).double()
    mu, tau = s[:, 0], torch.exp(s[:, 1])
    theta1 = s[:, 0] + tau * s[:, 2]
    got = {"mu mean": float(mu.mean()), "mu sd": float(mu.std(correction=0)),
           "tau mean": float(tau.mean()),
           "tau sd": float(tau.std(correction=0)),
           "theta1 mean": float(theta1.mean()),
           "mean depth": float(res.mean_depth),
           "divergence": float(res.divergence_rate),
           "accept": float(res.accept_rate)}
    bands = {"mu mean": (3.8, 5.0), "mu sd": (2.6, 4.0),
             "tau mean": (2.8, 4.4), "tau sd": (2.3, 4.1),
             "theta1 mean": (5.35, 7.15), "mean depth": (1.8, 4.0),
             "divergence": (0.0, 0.02), "accept": (0.7, 0.92)}
    log("nuts_eight_schools: " + json.dumps(dict(
        seconds=seconds,
        ms_per_transition=seconds * 1e3 / (2 * padded_length(800)),
        step_size=float(res.step_size), **got, bands=bands)))
    off = {k: v for k, v in got.items()
           if not bands[k][0] <= v <= bands[k][1]}
    if off or not bool(torch.isfinite(s).all()):
        raise AssertionError(f"nuts_eight_schools outside the Stan bands: "
                             f"{off}")
    return launch_counts()


# -------------------------------------------------------------------- rqs
def rqs_inputs(n, k, bounds, inverse, gen):
    """Random spline logits and points across the domain and both tails;
    every fifth row lies exactly on one of the plain version's knots, rows
    1 and 2 on the two bounds, and rows 3::97, 4::97, 6::97 are NaN, +inf
    and -inf."""
    from normalizingflow_tpu_torch.bijectors.rqs import _normalize_bins

    kw = dict(device=gen.device, dtype=torch.float32, generator=gen)
    w, h = torch.randn(n, k, **kw), torch.randn(n, k, **kw)
    d = torch.randn(n, k - 1, **kw)
    left, right, bottom, top = bounds
    lo, hi = (bottom, top) if inverse else (left, right)
    span = hi - lo
    x = lo - 0.3 * span + 1.6 * span * torch.rand(n, **kw)
    knots, _ = _normalize_bins(h if inverse else w, k, 1e-3, lo, hi)
    rows = torch.arange(0, n, 5, device=gen.device)
    at = torch.randint(0, k + 1, (rows.numel(),), device=gen.device,
                       generator=gen)
    x[rows] = knots[rows, at]
    x[1], x[2] = lo, hi
    x[3::97] = float("nan")
    x[4::97] = float("inf")
    x[6::97] = float("-inf")
    return x, w, h, d


def plain64(x, w, h, d, inverse, *bounds):
    """The plain version evaluated in float64 on the same (float32) inputs:
    what the kernel, float64 inside, is held against (csrc/rqs.cu says
    why)."""
    from normalizingflow_tpu_torch.ops.rqs import plain_rqs

    return plain_rqs(x.double(), w.double(), h.double(), d.double(),
                     inverse, *bounds)


def compare_rqs(y_k, ld_k, y_r, ld_r, label):
    """Kernel (y_k, ld_k) against the plain version: NaN and inf in the same
    places with the same values, finite entries at the tolerances above.
    Returns the largest finite |difference| of y and of ld."""
    errs = []
    for name, a, b, tol in (("y", y_k.double(), y_r.double(), RQS_Y_TOL),
                            ("ld", ld_k.double(), ld_r.double(),
                             RQS_LD_TOL)):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"rqs {label}: {name} NaN positions differ")
        inf = torch.isinf(b)
        if not torch.equal(torch.isinf(a), inf) or not torch.equal(
                a[inf], b[inf]):
            raise AssertionError(f"rqs {label}: {name} inf entries differ")
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], **tol,
                                   msg=lambda m: f"rqs {label} {name}: {m}")
        errs.append(float((a[fin] - b[fin]).abs().max()) if bool(fin.any())
                    else 0.0)
    return tuple(errs)


SECTOR_WORDS = 8  # float32 words in a 32-byte sector, the unit of access


def sector_bytes(need):
    """Bytes of the distinct 32-byte sectors holding the words that `need`
    (bool, shaped like a contiguous float32 array) marks."""
    flat = need.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % SECTOR_WORDS)])
    return 4 * SECTOR_WORDS * int(flat.view(-1, SECTOR_WORDS).any(1).sum())


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def rqs_bounds(x, w, h, inverse, bounds, circular=False):
    """Least times of the forward and of the VJP on this run's data, counted
    in the 32-byte sectors the function must read and write.

    A row outside the domain (NaN included) needs x alone: y = x, log-det
    0, gx = grad_y, and zero parameter gradients. A row inside needs all of
    its w and h (the softmaxes), grad_ld, and of d only its bin's two
    derivative logits (one at the edge bins 0 and K-1, whose outer slope is
    pinned; with `circular`, d has K logits and bin K-1's upper slope is
    logit 0's); the bin is found on the float64 knots. Every output is
    written whole: y and log-det, or gx, gw, gh and gd. Operations are counted from
    the jnp function for the rows inside (about 11K per softmax-floor-cumsum
    of w and h, 5K for the derivatives, K comparisons, 50 for the map; the
    VJP adds the map's reverse, about 150, and the spread onto 2K logits,
    about 8K), at the fp32 rate.

    Returns (forward bound, VJP bound, what was counted), each bound as
    (ms, "bytes" or "operations", bytes)."""
    from normalizingflow_tpu_torch.bijectors.rqs import (
        DEFAULT_MIN_BIN_HEIGHT,
        DEFAULT_MIN_BIN_WIDTH,
        _normalize_bins,
        _search_bins,
    )

    left, right, bottom, top = bounds
    lo, hi = (bottom, top) if inverse else (left, right)
    n, k = w.shape
    inside = (x >= lo) & (x <= hi)
    knots, _ = _normalize_bins(
        (h if inverse else w).double(), k,
        DEFAULT_MIN_BIN_HEIGHT if inverse else DEFAULT_MIN_BIN_WIDTH, lo, hi)
    idx = _search_bins(knots, x.double().clamp(lo, hi))[:, None]
    nd = k if circular else k - 1
    m = torch.arange(nd, device=x.device)
    lower, upper = (idx, (idx + 1) % k) if circular else (idx - 1, idx)
    need_d = inside[:, None] & ((m == lower) | (m == upper))
    every = torch.ones_like(inside)
    column = sector_bytes(every)                  # x, y, log-det, gy, gx
    params = sector_bytes(inside[:, None].expand(n, k))  # w or h
    d_read = sector_bytes(need_d)
    n_in = int(inside.sum())
    fwd = bound(3 * column + 2 * params + d_read, n_in * (28 * k + 50))
    vjp = bound(3 * column + sector_bytes(inside) + 2 * params + d_read
                + 2 * sector_bytes(every[:, None].expand(n, k))
                + sector_bytes(every[:, None].expand(n, nd)),
                n_in * (36 * k + 200))
    return fwd, vjp, dict(rows_inside=n_in / n,
                          d_bytes_per_row_inside=d_read / max(n_in, 1))


def check_rqs(n, k, bname, inverse, gen, flush):
    from normalizingflow_tpu_torch.ops.rqs import plain_rqs, rqs_cuda

    bounds = (RQS_BOUNDS | PATH_BOUNDS)[bname]
    x, w, h, d = rqs_inputs(n, k, bounds, inverse, gen)
    label = f"({n},{k}) {'inverse' if inverse else 'forward'} {bname}"
    want = plain64(x, w, h, d, inverse, *bounds)
    got = rqs_cuda(x, w, h, d, inverse, *bounds)  # CUDA tensors: the kernel
    torch.cuda.synchronize()
    err_y, err_ld = compare_rqs(*got, *want, label)
    # for the record: how far the float32 plain version is from float64
    f32 = plain_rqs(x, w, h, d, inverse, *bounds)
    gap_y, gap_ld = (float((a.double() - b).nan_to_num(0.0, 0.0, 0.0)
                           .abs().max()) for a, b in zip(f32, want))
    ms = cuda_time_ms(lambda: rqs_cuda(x, w, h, d, inverse, *bounds),
                      flush=flush)
    plain_ms = cuda_time_ms(lambda: plain_rqs(x, w, h, d, inverse, *bounds),
                            flush=flush)
    fwd_bound, vjp_bound, counted = rqs_bounds(x, w, h, inverse, bounds)
    bound_ms, bound_by, nbytes = fwd_bound
    log(f"kernels: rqs {label} f32 ok: max_abs_err y {err_y:.3g} ld "
        f"{err_ld:.3g} (float32 plain: y {gap_y:.3g} ld {gap_ld:.3g}), "
        f"ms {ms:.5f}, plain_ms {plain_ms:.5f}, bound_ms "
        f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e6:.2f} MB; rows inside "
        f"{counted['rows_inside']:.4f}, d "
        f"{counted['d_bytes_per_row_inside']:.2f} B a row inside), share of "
        f"bound {bound_ms / ms:.3f}")
    fwd = dict(max_abs_err=max(err_y, err_ld), ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    return fwd, check_rqs_vjp(x, w, h, d, inverse, bounds, label, gen,
                              flush, vjp_bound)


def vjp64(x, w, h, d, grad_y, grad_ld, inverse, *bounds):
    """The plain VJP evaluated in float64 on the same (float32) inputs."""
    from normalizingflow_tpu_torch.ops.rqs import rqs_vjp_plain

    return rqs_vjp_plain(*(t.double() for t in (x, w, h, d, grad_y,
                                                grad_ld)), inverse, *bounds)


def compare_vjp(got, want, label):
    """Backward kernel (gx, gw, gh, gd) against the float64 plain VJP: NaN
    in the same places, finite entries at RQS_GRAD_TOL. Returns the largest
    finite |difference|."""
    err = 0.0
    for name, a, b in zip(("gx", "gw", "gh", "gd"), got, want):
        a = a.double()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"rqs vjp {label}: {name} NaN positions "
                                 f"differ")
        fin = torch.isfinite(b)
        torch.testing.assert_close(
            a[fin], b[fin], **RQS_GRAD_TOL,
            msg=lambda m, name=name: f"rqs vjp {label} {name}: {m}")
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return err


def vjp_gap(got, want):
    """Largest |difference| over the entries finite in both."""
    gap = 0.0
    for a, b in zip(got, want):
        a = a.double()
        both = torch.isfinite(a) & torch.isfinite(b)
        if bool(both.any()):
            gap = max(gap, float((a[both] - b[both]).abs().max()))
    return gap


def check_rqs_vjp(x, w, h, d, inverse, bounds, label, gen, flush,
                  vjp_bound):
    from normalizingflow_tpu_torch.ops.rqs import (
        rqs_vjp_cuda,
        rqs_vjp_plain,
        twin_vjp,
    )

    gy = torch.randn(x.shape, device=x.device, generator=gen)
    gld = torch.randn(x.shape, device=x.device, generator=gen)
    args = (x, w, h, d, gy, gld, inverse, *bounds)
    want = vjp64(*args)
    got = rqs_vjp_cuda(*args)  # CUDA tensors: the kernel
    torch.cuda.synchronize()
    err = compare_vjp(got, want, label)
    gap = vjp_gap(twin_vjp(*args), want)
    if not err <= gap:
        raise AssertionError(f"rqs vjp {label}: kernel off the float64 VJP "
                             f"by {err}, the float32 autograd it replaced "
                             f"by {gap}")
    ms = cuda_time_ms(lambda: rqs_vjp_cuda(*args), reps=VJP_REPS,
                      flush=flush)
    plain_ms = cuda_time_ms(lambda: rqs_vjp_plain(*args), reps=VJP_REPS,
                            flush=flush)
    recompute_ms = cuda_time_ms(lambda: twin_vjp(*args), reps=VJP_REPS,
                                flush=flush)
    bound_ms, bound_by, nbytes = vjp_bound
    log(f"kernels: rqs_vjp {label} f32 ok: max_abs_err {err:.3g} (float32 "
        f"autograd recompute: {gap:.3g}), ms {ms:.5f}, plain_ms "
        f"{plain_ms:.5f}, recompute_ms {recompute_ms:.5f}, bound_ms "
        f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e6:.2f} MB), share of "
        f"bound {bound_ms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                recompute_ms=recompute_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ------------------------------------------------------------ circular
CRQS_SHAPES = [(64000, 16), (1000, 16)]
CRQS_HALF = 0.5 * (500 / 1.28) ** (1.0 / 3.0)  # lj500_nsf_tcl's box / 2


def crqs_inputs(n, k, half, inverse, gen):
    """Spline logits and points inside [-half, half]; every fifth row on a
    knot of the plain version, rows 1 and 2 on the two ends, rows 3::97
    NaN."""
    from normalizingflow_tpu_torch.bijectors.rqs import _normalize_bins

    kw = dict(device=gen.device, dtype=torch.float32, generator=gen)
    w, h, d = (torch.randn(n, k, **kw) for _ in range(3))
    x = (2.0 * torch.rand(n, **kw) - 1.0) * half
    knots, _ = _normalize_bins(h if inverse else w, k, 1e-3, -half, half)
    rows = torch.arange(0, n, 5, device=gen.device)
    at = torch.randint(0, k + 1, (rows.numel(),), device=gen.device,
                       generator=gen)
    x[rows] = knots[rows, at]
    x[1], x[2] = -half, half
    x[3::97] = float("nan")
    return x, w, h, d


def circular_phase(n, k, gen, flush):
    """Phase 18 at (n, k): the circular kernels against their plain
    versions in float64, both directions, and the ends' continuity.
    Returns {(n, k, inverse): (forward's numbers, the VJP's)}."""
    from normalizingflow_tpu_torch.ops.rqs import (
        crqs_cuda,
        crqs_vjp_cuda,
        crqs_vjp_plain,
        plain_crqs,
        twin_crqs_vjp,
    )

    bounds = (-CRQS_HALF, CRQS_HALF) * 2
    out = {}
    for inverse in (False, True):
        label = f"circular ({n},{k}) {'inverse' if inverse else 'forward'}"
        x, w, h, d = crqs_inputs(n, k, CRQS_HALF, inverse, gen)
        want = plain_crqs(*(t.double() for t in (x, w, h, d)), inverse,
                          *bounds)
        got = crqs_cuda(x, w, h, d, inverse, *bounds)
        torch.cuda.synchronize()
        err_y, err_ld = compare_rqs(*got, *want, label)
        # the round trip, on rows whose slope lies in [0.1, 10]: where the
        # map is flatter, float32's rounding of y moves the way back more
        back = crqs_cuda(got[0], w, h, d, not inverse, *bounds)[0]
        fair = torch.isfinite(x) & (got[1].abs() <= math.log(10.0))
        trip = float((back - x)[fair].abs().max())
        if not trip <= 1e-4:
            raise AssertionError(f"{label}: round trip off by {trip}")
        gy, gld = (torch.randn(n, device=x.device, generator=gen)
                   for _ in range(2))
        args = (x, w, h, d, gy, gld, inverse, *bounds)
        vjp_want = crqs_vjp_plain(*(t.double() for t in args[:6]),
                                  *args[6:])
        vjp_got = crqs_vjp_cuda(*args)
        torch.cuda.synchronize()
        err_g = compare_vjp(vjp_got, vjp_want, label)
        gap = vjp_gap(twin_crqs_vjp(*args), vjp_want)
        if not err_g <= gap:
            raise AssertionError(f"{label}: kernel VJP off the float64 VJP "
                                 f"by {err_g}, float32 autograd by {gap}")
        ms = cuda_time_ms(lambda: crqs_cuda(x, w, h, d, inverse, *bounds),
                          flush=flush)
        plain_ms = cuda_time_ms(lambda: plain_crqs(x, w, h, d, inverse,
                                                   *bounds), flush=flush)
        vjp_ms = cuda_time_ms(lambda: crqs_vjp_cuda(*args), reps=VJP_REPS,
                              flush=flush)
        vjp_plain_ms = cuda_time_ms(lambda: crqs_vjp_plain(*args),
                                    reps=VJP_REPS, flush=flush)
        fwd_bound, vjp_bound, _ = rqs_bounds(x, w, h, inverse, bounds,
                                             circular=True)
        log(f"kernels: rqs {label} f32 ok: max_abs_err y {err_y:.3g} ld "
            f"{err_ld:.3g}, round trip {trip:.3g}, ms {ms:.5f}, plain_ms "
            f"{plain_ms:.5f}, bound_ms {fwd_bound[0]:.5f} ({fwd_bound[1]}, "
            f"{fwd_bound[2] / 1e6:.2f} MB); vjp max_abs_err {err_g:.3g} "
            f"(float32 autograd recompute {gap:.3g}), ms {vjp_ms:.5f}, "
            f"plain_ms {vjp_plain_ms:.5f}, bound_ms {vjp_bound[0]:.5f} "
            f"({vjp_bound[1]}, {vjp_bound[2] / 1e6:.2f} MB)")
        out[(n, k, inverse)] = tuple(
            dict(max_abs_err=err, ms=t, plain_ms=p, bound_ms=b[0],
                 bound_by=b[1])
            for err, t, p, b in ((max(err_y, err_ld), ms, plain_ms,
                                  fwd_bound),
                                 (err_g, vjp_ms, vjp_plain_ms, vjp_bound)))
    # the two ends are one point of the circle, with one slope
    x = torch.tensor([-CRQS_HALF, CRQS_HALF], device="cuda")
    w, h, d = (torch.randn(1, k, device="cuda", generator=gen).expand(2, k)
               for _ in range(3))
    y, ld = crqs_cuda(x, w, h, d, False, *bounds)
    if not (torch.allclose(y, x, atol=1e-5) and abs(float(ld[0] - ld[1]))
            <= 1e-5):
        raise AssertionError(f"circular ends: y {y.tolist()}, log-slopes "
                             f"{ld.tolist()}")
    return out


CRQS_PATH_BATCH = 8  # draws of the NSF_TCL path's step, sample and density


def fcc_sites(cells, boxlength):
    """The fcc lattice of cells^3 cubic cells filling [-L/2, L/2)^3,
    (4 cells^3, 3)."""
    a = boxlength / cells
    basis = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5],
                          [0.5, 0.5, 0.0]], dtype=torch.float64)
    r = torch.arange(cells, dtype=torch.float64)
    grid = torch.cartesian_prod(r, r, r)
    sites = (grid[:, None, :] + basis + 0.25) * a - 0.5 * boxlength
    return sites.reshape(-1, 3)


def circular_path(seed, device="cuda", cells=5, layers=24, embed_dim=256):
    """The circular kernels' launches on the main path: NSF_TCL at
    lj500_nsf_tcl's widths and depth (by default: 24 coupling layers, N =
    500 in 5^3 fcc cells) built by `config.setup_model`, one reverse-KL `train_step` with
    `bench_optimizer`, then `flow.sample` and `flow.log_prob` without
    gradient, each at CRQS_PATH_BATCH draws, the counters zeroed before
    each. A layer launches one circular forward in either direction and
    its VJP once in the backward; no other kernel runs. Returns
    {path: (forward launches, VJP launches)}."""
    from normalizingflow_tpu_torch.config import (
        Config,
        DatasetConfig,
        FlowConfig,
        PriorConfig,
        setup_model,
    )
    from normalizingflow_tpu_torch.ops import rqs
    from normalizingflow_tpu_torch.train.loop import (
        bench_optimizer,
        train_step,
    )

    n = 4 * cells ** 3
    box = (n / 1.28) ** (1.0 / 3.0)
    cfg = Config(
        dataset=DatasetConfig(potential="LJ", nparticles=n, dim=3, kT=2.0,
                              rho=1.28, cutoff=2.7, shift=True),
        flow=FlowConfig(type="NSF_TCL", nlayers=layers, nsplines=16,
                        embed_dim=embed_dim, num_heads=2, num_blocks=2,
                        num_freqs=8),
        prior=PriorConfig(type="EinsteinCrystal", alpha=1000.0,
                          centers=fcc_sites(cells, box).tolist()))
    gen = torch.Generator(device=device).manual_seed(seed)
    flow, target, _ = setup_model(cfg, device=device, dtype=torch.float32,
                                  generator=gen)
    opt = bench_optimizer(list(flow.parameters()), 100000, 500, 1e-4)

    def counted(fn):
        reset_launch_counts()
        rqs.crqs_cuda.launches = rqs.crqs_vjp_cuda.launches = 0
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        if launch_counts() != dict.fromkeys(launch_counts(), 0):
            raise AssertionError(f"NSF_TCL path: launches {launch_counts()}"
                                 f"; no other kernel runs there")
        return out, (rqs.crqs_cuda.launches, rqs.crqs_vjp_cuda.launches)

    z = flow.prior.sample(CRQS_PATH_BATCH, generator=gen)
    loss, step = counted(lambda: train_step(flow, target, opt, z))
    with torch.no_grad():
        (x, log_px, _), sample = counted(
            lambda: flow.sample(CRQS_PATH_BATCH, generator=gen))
        log_q, density = counted(lambda: flow.log_prob(x))
    paths = dict(nsf_tcl_train_step=step, nsf_tcl_sample=sample,
                 nsf_tcl_density=density)
    want = dict(nsf_tcl_train_step=(layers, layers),
                nsf_tcl_sample=(layers, 0), nsf_tcl_density=(layers, 0))
    if paths != want:
        raise AssertionError(f"NSF_TCL path: launches (forward, VJP) "
                             f"{paths}, the code implies {want}")
    # float32 densities of ~1500 coordinates, through 24 layers each way
    gap = float((log_q - log_px).abs().max())
    if not (math.isfinite(float(loss))
            and gap <= 1e-3 + 1e-5 * float(log_px.abs().max())):
        raise AssertionError(f"NSF_TCL path: loss {float(loss)}, density "
                             f"off the sample's by {gap}")
    log(f"circular path: {json.dumps(paths)}, loss {float(loss):.6g}, "
        f"density round trip {gap:.3g}")
    return paths


# ------------------------------------------------------------ bench
def finite_numbers(value):
    """Every number in a JSON value (nested dicts and lists) is finite."""
    if isinstance(value, dict):
        return all(finite_numbers(v) for v in value.values())
    if isinstance(value, list):
        return all(finite_numbers(v) for v in value)
    return not isinstance(value, float) or math.isfinite(value)


def bench_phase(flow, main_stats, keep, seed):
    """The port's bench entry points (normalizingflow_tpu_torch/bench.py,
    bench_scaling.py) at their widths: bench.timed_sampling on the funnel
    flow that main_path trained, the Gaussian line (its training cut), the
    NUTS line, the speed-of-light row, then bench_scaling.throughput at
    NCCL world size 1. The line is assembled by bench.headline (the spline
    line is left out: the spline phase drives that path) and must parse
    with every ported key present and finite; the funnel's accept and v
    band are main_path's gates; ESS at most its cap; the fused accept
    kernel launches padded_length(draws) times in each timed run, and
    exactly the transitions of each path in all; NUTS and the row launch
    none; mfu_vs_fp32_peak in (0, 1]. Returns the launches by path."""
    import torch.distributed as dist

    from normalizingflow_tpu_torch import bench, bench_scaling
    from normalizingflow_tpu_torch.mcmc import padded_length
    from normalizingflow_tpu_torch.parallel import make_mesh
    from normalizingflow_tpu_torch.targets import NealsFunnel

    depth_cut("bench", "funnel train steps (main's flow)",
              main_stats["train_steps"], bench.TRAIN_STEPS)
    depth_cut("bench", "funnel and gauss draws", BENCH_DRAWS, bench.DRAWS)
    depth_cut("bench", "gauss train steps", BENCH_GAUSS_STEPS,
              bench.TRAIN_STEPS)
    depth_cut("bench", "nuts draws", BENCH_NUTS_DRAWS, bench.NUTS_DRAWS)
    depth_cut("bench", "scaling draws", BENCH_SCALING_DRAWS,
              bench_scaling.DRAWS)
    t_phase = time.perf_counter()
    paths, seconds = {}, {}

    def counted(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        paths[name] = launch_counts()
        return out

    funnel = counted("bench_funnel", lambda: bench.timed_sampling(
        flow, NealsFunnel(DIM), torch.Generator(device="cuda").manual_seed(
            seed + 30), draws=BENCH_DRAWS))
    funnel.update(bench.funnel_v_stats(funnel.pop("samples")))
    funnel.update(train_s=round(main_stats["train_s"], 1),
                  final_reverse_kl=round(main_stats["final_reverse_kl"], 3))
    gauss = counted("bench_gauss", lambda: bench.gauss_line(
        torch.Generator(device="cuda").manual_seed(seed + 31),
        draws=BENCH_DRAWS, train_steps=BENCH_GAUSS_STEPS))
    nuts = counted("bench_nuts", lambda: bench.nuts_ess_line(
        flow, NealsFunnel(DIM), torch.Generator(device="cuda").manual_seed(
            seed + 32), draws=BENCH_NUTS_DRAWS))
    gen = torch.Generator(device="cuda").manual_seed(seed + 33)
    fresh = bench.build_flow(generator=gen)
    mfu = counted("bench_mfu", lambda: bench.mfu_fwd_logdet(fresh, gen))
    # the profiler's kernel time of one such call, beside the row's
    x = torch.randn(bench.CHAINS, DIM, generator=gen, device="cuda")
    with torch.no_grad():
        profiled = device_idle(lambda: fresh(x))
    line = bench.headline(funnel, nuts, gauss, None, mfu,
                          torch.cuda.get_device_name(0),
                          bench.parse_power_limit(device_line()))
    text = json.dumps(line)
    log("bench: " + text)

    dist.init_process_group("nccl", init_method=f"file://{keep}/bench_store",
                            world_size=1, rank=0)
    try:
        thr, dt = counted("bench_scaling_w1", lambda: bench_scaling.throughput(
            make_mesh(), flow, NealsFunnel(DIM),
            torch.Generator(device="cuda").manual_seed(seed + 34),
            draws=BENCH_SCALING_DRAWS))
    finally:
        dist.destroy_process_group()
    scaling = dict(value=thr, sample_s=dt,
                   chains=bench_scaling.CHAINS_PER_DEVICE,
                   draws=BENCH_SCALING_DRAWS)
    log("bench: " + json.dumps(dict(
        scaling_w1=scaling, fwd_logdet_profiled=profiled, seconds=seconds,
        phase_s=time.perf_counter() - t_phase)))

    parsed = json.loads(text)
    detail = parsed["detail"]
    missing = [k for k in BENCH_FUNNEL_KEYS if k not in detail]
    missing += [f"gaussian_secondary.{k}" for k in BENCH_HMC_KEYS
                if k not in detail["gaussian_secondary"]]
    missing += [f"nuts_funnel.{k}" for k in BENCH_NUTS_KEYS
                if k not in detail["nuts_funnel"]]
    if (parsed["metric"] != bench.METRIC or missing
            or not finite_numbers(parsed) or not math.isfinite(thr)):
        raise AssertionError(f"bench: line {text} lacks {missing} or holds "
                             f"a non-finite number")
    if not 0.6 <= detail["accept"] <= 0.95:
        raise AssertionError(f"bench: funnel accept {detail['accept']}")
    if abs(detail["v_mean"]) >= 0.15 or abs(detail["v_var"] - 9.0) >= 0.9:
        raise AssertionError(f"bench: funnel v mean {detail['v_mean']}, "
                             f"var {detail['v_var']} (exact 0, 9)")
    for name, part in (("funnel", detail), ("gauss", gauss), ("nuts", nuts)):
        ess_min = min(part["ess_min_bulk_x"], part["ess_min_bulk_x2"])
        if not 0 < ess_min <= part["ess_cap"]:
            raise AssertionError(f"bench: {name} ESS {ess_min}, cap "
                                 f"{part['ess_cap']}")
    if not 0 < detail["mfu_vs_fp32_peak"] <= 1:
        raise AssertionError(f"bench: mfu {detail['mfu_vs_fp32_peak']}")
    adapt = padded_length(WARMUP) + padded_length(2)
    timed = padded_length(BENCH_DRAWS)
    scaled = padded_length(BENCH_SCALING_DRAWS)
    want = dict(bench_funnel=adapt + 4 * timed, bench_gauss=adapt + 4 * timed,
                bench_nuts=0, bench_mfu=0,
                bench_scaling_w1=padded_length(bench_scaling.WARMUP)
                + padded_length(2) + 2 * scaled)
    for name, count in want.items():
        expect = dict(accept_select=count, accept_unfused=0, rqs=0,
                      rqs_vjp=0)
        if paths[name] != expect:
            raise AssertionError(f"bench: {name} launches {paths[name]}, "
                                 f"the code implies {expect}")
    for name, part in (("funnel", funnel), ("gauss", gauss)):
        if part["accept_launches_all"] != [timed] * bench.TIMED_RUNS:
            raise AssertionError(f"bench: {name} timed runs launched "
                                 f"{part['accept_launches_all']}, want "
                                 f"{timed} each")
    return paths


# ------------------------------------------------------------ spline line
def build_spline_flow(gen, device):
    from normalizingflow_tpu_torch import NormalizingFlow
    from normalizingflow_tpu_torch.bijectors import Chain, SplineCoupling
    from normalizingflow_tpu_torch.distributions import DiagNormal

    kw = dict(device=device, dtype=torch.float32)
    return NormalizingFlow(DiagNormal(SP_DIM, **kw), Chain([
        SplineCoupling(SP_SIZE, SP_SPACE, num_bins=SP_BINS,
                       tail_bound=SP_TAIL, hidden_dim=SP_HIDDEN, mask=(a,),
                       generator=gen, **kw)
        for a in range(SP_SPACE)]))


def spline_layer_checks(flow, z, gen):
    """Each SplineCoupling's kernels against the plain versions on the
    layer's own w, h, d: inverse from z down to x, then forward back up;
    the backward kernel with random cotangents. Returns (max |err| y,
    max |err| log-det, max |err| of the VJP)."""
    from normalizingflow_tpu_torch.ops.rqs import rqs_cuda, rqs_vjp_cuda

    layers = list(flow.bijector.bijectors)
    errs, vjp_errs = [], []
    with torch.no_grad():
        y = z
        for inverse, order in ((True, layers[::-1]), (False, layers)):
            for i, layer in enumerate(order):
                cond, trans = layer.split(y)
                w, h, d = layer.spline_params(cond)
                b = (-layer.tail_bound, layer.tail_bound) * 2
                label = f"trained layer {i} inverse={inverse}"
                got = rqs_cuda(trans, w, h, d, inverse, *b)
                want = plain64(trans, w, h, d, inverse, *b)
                errs.append(compare_rqs(*got, *want, label))
                cot = [torch.randn(trans.shape, device=trans.device,
                                   generator=gen) for _ in range(2)]
                vjp_errs.append(compare_vjp(
                    rqs_vjp_cuda(trans, w, h, d, *cot, inverse, *b),
                    vjp64(trans, w, h, d, *cot, inverse, *b), label))
                y = layer.join(cond, got[0])
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            max(vjp_errs))


def round_trip(flow, z, label):
    """max |forward(inverse(z)) - z| and max |log-dets' sum| on the card;
    raises past 1e-4 and 1e-3."""
    with torch.no_grad():
        x, ld_inv = flow.inverse(z)
        z2, ld_fwd = flow.bijector.forward(x)
    rt_z = float((z2 - z).abs().max())
    rt_ld = float((ld_inv + ld_fwd).abs().max())
    if not rt_z <= 1e-4 or not rt_ld <= 1e-3:
        raise AssertionError(f"{label} round trip off: z {rt_z}, log-det "
                             f"{rt_ld}")
    return rt_z, rt_ld


def spline_line(seed, device="cuda"):
    from normalizingflow_tpu_torch.estimators.ess import (
        bulk_ess_per_dim,
        tail_ess,
    )
    from normalizingflow_tpu_torch.mcmc import (
        neutra_hmc,
        padded_length,
        push_to_data,
    )
    from normalizingflow_tpu_torch.mcmc.neutra import PUSH_CHUNK
    from normalizingflow_tpu_torch.ops.hmc import (
        accept_select,
        accept_select_fused,
    )
    from normalizingflow_tpu_torch.ops.rqs import rqs_cuda, rqs_vjp_cuda
    from normalizingflow_tpu_torch.targets import NealsFunnel
    from normalizingflow_tpu_torch.train.loop import train
    from normalizingflow_tpu_torch.train.objectives import reverse_kl

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    flow = build_spline_flow(gen, device)
    target = NealsFunnel(SP_DIM)
    layers = len(flow.bijector.bijectors)
    with torch.no_grad():
        initial_kl = float(reverse_kl(
            flow, target, z=flow.prior.sample(SP_BATCH, generator=gen)))

    accept_select.launches = 0
    accept_select_fused.launches = 0
    rqs_cuda.launches = 0
    rqs_vjp_cuda.launches = 0
    t0 = time.perf_counter()
    final_kl = train(flow, target, SP_TRAIN_STEPS, SP_BATCH, gen,
                     device=device, warmup_steps=SP_LR_WARMUP,
                     peak_lr=SP_PEAK_LR)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = rqs_cuda.launches
    train_vjp_launches = rqs_vjp_cuda.launches

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = neutra_hmc(gen, flow, target, SP_CHAINS, SP_DRAWS,
                     num_warmup=WARMUP, step_size=0.5, num_leapfrog=LEAPFROG,
                     device=device)
    end.record()
    torch.cuda.synchronize()
    rqs_launches = rqs_cuda.launches
    vjp_launches = rqs_vjp_cuda.launches
    acc_launches = accept_select_fused.launches
    acc_unfused = accept_select.launches
    sample_s = start.elapsed_time(end) / 1e3
    # the flow's own push-forward, where the chains start
    v_flow = push_to_data(flow, flow.prior.sample(
        SP_CHAINS, generator=gen))[:, 0]

    # Every train step and every gradient evaluation runs each layer's
    # forward kernel once and, in its backward, the VJP kernel once; the
    # push (no gradient) runs the forward only, once a chunk.
    transitions = padded_length(WARMUP) + padded_length(SP_DRAWS)
    grad_evals = 1 + LEAPFROG * transitions
    chunks = -(-SP_CHAINS * SP_DRAWS // PUSH_CHUNK)
    expected = layers * (SP_TRAIN_STEPS + grad_evals + chunks)
    expected_vjp = layers * (SP_TRAIN_STEPS + grad_evals)

    xs = res.samples_x
    bulk_x = bulk_ess_per_dim(xs)
    bulk_x2 = bulk_ess_per_dim(xs * xs)
    ess_min = float(torch.minimum(bulk_x.min(), bulk_x2.min()))
    hardest = int(torch.argmin(bulk_x))
    ess_tail = float(tail_ess(xs[:, :, hardest]))
    v = xs[..., 0]
    accept = float(res.accept_rate)
    v_mean, v_var = float(v.mean()), float(v.var(correction=0))
    stats = dict(
        train_steps=SP_TRAIN_STEPS, train_batch=SP_BATCH, train_s=train_s,
        initial_reverse_kl=initial_kl, final_reverse_kl=final_kl,
        chains=SP_CHAINS, warmup=WARMUP,
        draws=SP_DRAWS, leapfrog=LEAPFROG, transitions=transitions,
        gradient_evaluations=grad_evals, push_chunks=chunks,
        rqs_launches=rqs_launches, rqs_launches_train=train_launches,
        rqs_launches_expected=expected, rqs_vjp_launches=vjp_launches,
        rqs_vjp_launches_train=train_vjp_launches,
        rqs_vjp_launches_expected=expected_vjp, accept_launches=acc_launches,
        accept_unfused_launches=acc_unfused,
        accept=accept, step_size=float(res.step_size),
        v_mean=v_mean, v_var=v_var,
        v_in_band=abs(v_mean) < 0.5 and abs(v_var - 9.0) < 3.0,
        flow_v_mean=float(v_flow.mean()),
        flow_v_var=float(v_flow.var(correction=0)),
        ess_min_bulk_x=float(bulk_x.min()),
        ess_min_bulk_x2=float(bulk_x2.min()), ess_min=ess_min,
        ess_tail_hardest_coord=ess_tail, sample_s=sample_s,
        ess_per_s_with_warmup=ess_min / sample_s,
        ms_per_transition=sample_s * 1e3 / transitions)
    log("spline: " + json.dumps(stats))

    if rqs_launches != expected:
        raise AssertionError(f"rqs launched {rqs_launches} times, the code "
                             f"implies {expected}")
    if vjp_launches != expected_vjp:
        raise AssertionError(f"rqs_vjp launched {vjp_launches} times, the "
                             f"code implies {expected_vjp}")
    if acc_launches != transitions or acc_unfused != 0:
        raise AssertionError(f"the fused accept kernel launched "
                             f"{acc_launches} times for {transitions} "
                             f"transitions, the unfused form {acc_unfused} "
                             f"times")
    if not bool(torch.isfinite(xs).all()) or not all(
            math.isfinite(x) for x in (final_kl, ess_min, ess_tail, accept)):
        raise AssertionError("spline: non-finite output")
    if xs.shape != (SP_DRAWS, SP_CHAINS, SP_DIM):
        raise AssertionError(f"spline samples shape {tuple(xs.shape)}")
    if not 0.6 <= accept <= 0.95:
        raise AssertionError(f"spline accept {accept} outside [0.6, 0.95]")
    if not final_kl < initial_kl - 1.0:
        raise AssertionError(f"spline training did not learn: reverse KL "
                             f"{initial_kl} -> {final_kl}")
    # The chains start from the flow's push-forward; HMC on a right
    # pullback moves v's law from there toward the funnel's (0, 9).
    flow_v_var = stats["flow_v_var"]
    if not abs(v_var - 9.0) < abs(flow_v_var - 9.0):
        raise AssertionError(f"spline HMC moved var(v) away from 9: flow "
                             f"{flow_v_var}, HMC {v_var}")

    z = res.samples_z[0]
    err_y, err_ld, err_vjp = spline_layer_checks(flow, z, gen)
    rt_z, rt_ld = round_trip(flow, z, "spline")
    log(f"spline: trained-flow kernels vs plain on {z.shape[0]} pushed "
        f"draws, {layers} layers x 2 directions ok: max_abs_err y "
        f"{err_y:.3g} ld {err_ld:.3g} vjp {err_vjp:.3g}; round trip max "
        f"|z err| {rt_z:.3g}, max |log-det sum| {rt_ld:.3g}")
    return dict(rqs=rqs_launches, rqs_vjp=vjp_launches,
                accept_select=acc_launches, max_abs_err=max(err_y, err_ld),
                max_abs_err_vjp=err_vjp, step_size=stats["step_size"],
                flow=flow)


# -------------------------------------------------------------- per_point
def rel_err(a, b):
    """max |a - b| over max |b|: the error relative to the tensor's scale."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def launched(fn):
    """fn() with every launch counter set to 0 just before; returns (its
    result, the counts just after)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def expect_launches(label, counts, accept, rqs):
    """Raise unless `counts` are `accept` fused accept launches (the
    unfused form none) and `rqs` launches of the RQS forward and of its
    VJP each."""
    want = dict(accept_select=accept, accept_unfused=0, rqs=rqs, rqs_vjp=rqs)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, the code "
                             f"implies {want}")


def replay_draws(generator, chains, dim, dtype, device):
    """nuts.TransitionDraws that give every consumer the same numbers:
    each draw is made at its first request and kept, so a per-point and a
    batched transition see one tree's draws."""
    from normalizingflow_tpu_torch.mcmc.nuts import TransitionDraws

    class Replay(TransitionDraws):
        def __init__(self):
            super().__init__(generator, chains, dim, dtype, device)
            self.memo = {}

        def kept(self, key, make):
            if key not in self.memo:
                self.memo[key] = make()
            return self.memo[key]

        def momentum(self):
            return self.kept("m", super().momentum)

        def direction(self, depth):
            return self.kept(("d", depth), lambda: super(
                Replay, self).direction(depth))

        def take(self, depth):
            return self.kept(("t", depth), lambda: super(
                Replay, self).take(depth))

        def leaf(self, depth, n):
            return self.kept(("l", depth, n), lambda: super(
                Replay, self).leaf(depth, n))

    return Replay()


def pp_line(label, point, batch, z, step, layers, gen):
    """A flow's per-point HMC against its batched HMC on one draw stream:
    value and gradient at z; PP_TRANSITIONS transitions of
    hmc_kernel_batched against hmc_kernel_chainbatched, the first held
    chain by chain; then run_hmc(batched_target=False), PP_WARMUP +
    PP_DRAWS, under the funnel's accept gate. Exact launches throughout:
    one accept launch a transition, one RQS forward and VJP a layer a
    gradient evaluation, per point as batched. Returns (stats, the
    per-point launches)."""
    from normalizingflow_tpu_torch.mcmc import (
        batched_lp_grad,
        hmc_init,
        hmc_kernel_batched,
        hmc_kernel_chainbatched,
        padded_length,
        pointwise_lp_grad,
        run_hmc,
        transition_draws,
    )

    chains, dim = z.shape
    ones = torch.ones(dim, device=z.device)
    tol = PP_RTOL[label]
    (lp_p, g_p), at_z = launched(lambda: pointwise_lp_grad(point)(z))
    lp_b, g_b = batched_lp_grad(batch)(z)
    expect_launches(f"per_point {label} value and gradient", at_z, 0,
                    layers)
    err_lp, err_g = rel_err(lp_p, lp_b), rel_err(g_p, g_b)
    if not (err_lp <= tol and err_g <= tol):
        raise AssertionError(f"per_point {label}: value off by {err_lp}, "
                             f"gradient by {err_g} (relative; {tol})")

    draws = [transition_draws(gen, chains, dim, z.dtype, z.device)
             for _ in range(PP_TRANSITIONS)]

    def transitions(kernel, lp_grad):
        state = hmc_init(lp_grad, z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = None
        for d in draws:
            state, info = kernel(d, state)
            first = first or (state, info)
        torch.cuda.synchronize()
        return first, state, (time.perf_counter() - t0) * 1e3 / len(draws)

    (first_p, last_p, ms_p), n_p = launched(lambda: transitions(
        hmc_kernel_batched(point, step, LEAPFROG, ones),
        pointwise_lp_grad(point)))
    (first_b, last_b, ms_b), n_b = launched(lambda: transitions(
        hmc_kernel_chainbatched(batch, step, LEAPFROG, ones),
        batched_lp_grad(batch)))
    evals = 1 + LEAPFROG * PP_TRANSITIONS
    expect_launches(f"per_point {label} per-point transitions", n_p,
                    PP_TRANSITIONS, layers * evals)
    expect_launches(f"per_point {label} batched transitions", n_b,
                    PP_TRANSITIONS, layers * evals)
    # the first transition chain by chain: a decision may differ only
    # where log u lies within PP_POS_TOL of min(0, dH)
    (s_p, i_p), (s_b, i_b) = first_p, first_b
    differ = i_p.accepted != i_b.accepted
    margin = (torch.log(draws[0][2])
              - torch.clamp(i_b.energy_change, max=0.0)).abs()
    if bool((differ & (margin >= PP_POS_TOL)).any()):
        raise AssertionError(f"per_point {label}: accept decisions differ "
                             f"away from the threshold")
    pos_err = float((s_p.position - s_b.position)[~differ].abs().max())
    if not pos_err <= PP_POS_TOL:
        raise AssertionError(f"per_point {label}: first transition's "
                             f"positions off by {pos_err}")
    agree = float(((last_p.position - last_b.position).abs().amax(1)
                   <= PP_POS_TOL).float().mean())

    t0 = time.perf_counter()
    res, n_run = launched(lambda: run_hmc(
        gen, point, z, PP_DRAWS, num_warmup=PP_WARMUP, step_size=step,
        num_leapfrog=LEAPFROG, device=z.device, batched_target=False))
    run_s = time.perf_counter() - t0
    n = padded_length(PP_WARMUP) + padded_length(PP_DRAWS)
    expect_launches(f"per_point {label} run_hmc", n_run, n,
                    layers * (1 + LEAPFROG * n))
    accept = float(res.accept_rate)
    stats = dict(
        chains=chains, value_rel_err=err_lp, grad_rel_err=err_g,
        first_decisions_differ=int(differ.sum()),
        first_position_err=pos_err,
        chains_within_tol_after=dict(transitions=PP_TRANSITIONS,
                                     share=agree),
        ms_per_transition=ms_p, batched_ms_per_transition=ms_b,
        run=dict(warmup=PP_WARMUP, draws=PP_DRAWS, transitions=n,
                 seconds=run_s, ms_per_transition=run_s * 1e3 / n,
                 accept=accept, step_size=float(res.step_size)),
        launches_per_point=n_p, launches_batched=n_b, launches_run=n_run)
    log(f"per_point {label}: " + json.dumps(stats))
    if not bool(torch.isfinite(res.samples).all()) or not 0.6 <= accept \
            <= 0.95:
        raise AssertionError(f"per_point {label}: run_hmc accept {accept} "
                             f"outside [0.6, 0.95] or non-finite samples")
    return stats, {k: at_z[k] + n_p[k] + n_run[k] for k in at_z}


def pp_nuts(point, batch, z, step, gen):
    """PP_NUTS NUTS transitions through nuts_kernel (per point) against
    nuts_transition (batched), each pair from one state on one tree's
    draws: depth and position alike on PP_NUTS_AGREE of the chains; no
    kernel launched."""
    from normalizingflow_tpu_torch.mcmc import (
        batched_lp_grad,
        hmc_init,
        nuts_kernel,
        nuts_transition,
    )

    chains, dim = z.shape
    ones = torch.ones(dim, device=z.device)
    lp_grad = batched_lp_grad(batch)
    kernel = nuts_kernel(point, step, ones, NUTS_MAX_DEPTH)
    state = hmc_init(lp_grad, z)
    reset_launch_counts()
    before = launch_counts()
    shares, ms_p, ms_b = [], 0.0, 0.0
    for _ in range(PP_NUTS):
        draws = replay_draws(gen, chains, dim, z.dtype, z.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, info_p = kernel(draws, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new_b, info_b = nuts_transition(lp_grad, state, draws, step, ones,
                                        NUTS_MAX_DEPTH)
        torch.cuda.synchronize()
        ms_p += (t1 - t0) * 1e3 / PP_NUTS
        ms_b += (time.perf_counter() - t1) * 1e3 / PP_NUTS
        alike = (info_p.depth == info_b.depth) & (
            (new_p.position - new_b.position).abs().amax(1) <= PP_POS_TOL)
        shares.append(float(alike.float().mean()))
        state = new_b
    no_kernel_moved("per_point nuts", before)
    stats = dict(transitions=PP_NUTS, max_depth=NUTS_MAX_DEPTH,
                 chains_alike=shares, ms_per_transition=ms_p,
                 batched_ms_per_transition=ms_b)
    log("per_point nuts: " + json.dumps(stats))
    if min(shares) < PP_NUTS_AGREE:
        raise AssertionError(f"per_point nuts: chains alike {shares}, "
                             f"below {PP_NUTS_AGREE}")
    return stats


def pp_standard_normal(gen):
    """tests/test_nuts_smc.py test_nuts_standard_normal's per-point target
    on the card: the port's default refuses it (run_nuts and run_hmc),
    batched_target=False samples it within the test's bands."""
    from normalizingflow_tpu_torch.mcmc import padded_length, run_hmc, run_nuts

    def logprob(x):
        return -0.5 * torch.sum(x * x)

    device = gen.device
    init = torch.randn(PP_NORMAL_CHAINS, 4, generator=gen, device=device)
    for sampler in (run_nuts, run_hmc):
        try:
            sampler(gen, logprob, init, 2, num_warmup=0, device=device)
        except ValueError as err:
            if "batched_target=False" not in str(err):
                raise
        else:
            raise AssertionError(f"{sampler.__name__} took a per-point "
                                 f"target as batched")
    reset_launch_counts()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_nuts(gen, logprob, init, PP_NORMAL_DRAWS,
                   num_warmup=PP_NORMAL_WARMUP, step_size=0.2, max_depth=6,
                   device=device, batched_target=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_kernel_moved("per_point standard normal", before)
    s = res.samples.reshape(-1, 4).double()
    mean, var = s.mean(0), s.var(0, correction=0)
    stats = dict(chains=PP_NORMAL_CHAINS, warmup=PP_NORMAL_WARMUP,
                 draws=PP_NORMAL_DRAWS, seconds=seconds,
                 ms_per_transition=seconds * 1e3 / (
                     padded_length(PP_NORMAL_WARMUP)
                     + padded_length(PP_NORMAL_DRAWS)),
                 mean=mean.tolist(), var=var.tolist(),
                 mean_depth=float(res.mean_depth),
                 divergence_rate=float(res.divergence_rate),
                 accept=float(res.accept_rate))
    log("per_point standard normal: " + json.dumps(stats))
    if not (float(mean.abs().max()) < 0.1
            and float((var - 1.0).abs().max()) < 0.12
            and stats["divergence_rate"] < 0.01
            and 1.0 <= stats["mean_depth"] <= 6.0):
        raise AssertionError("per_point standard normal outside "
                             "tests/test_nuts_smc.py's bands")
    return stats


def per_point_phase(keep, spline_flow, funnel_step, spline_step, seed):
    """Phase 16: the JAX package's per-point targets on the flows phases 4
    and 5 trained. Returns the per-point launches of each kernel."""
    from normalizingflow_tpu_torch.mcmc import (
        pullback_logprob,
        pullback_logprob_batched,
    )
    from normalizingflow_tpu_torch.mcmc.neutra import frozen
    from normalizingflow_tpu_torch.targets import NealsFunnel

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    funnel, target = funnel_model(keep, "cuda")
    z = funnel.prior.sample(CHAINS, generator=gen)
    point = pullback_logprob(funnel, target)
    batch = pullback_logprob_batched(funnel, target)
    funnel_stats, funnel_n = pp_line("funnel", point, batch, z, funnel_step,
                                     0, gen)
    nuts = pp_nuts(point, batch, z[:NUTS_CHAINS], funnel_step, gen)
    del funnel
    torch.cuda.empty_cache()
    with frozen(spline_flow):
        target = NealsFunnel(SP_DIM)
        z = spline_flow.prior.sample(SP_CHAINS, generator=gen)
        spline_stats, spline_n = pp_line(
            "spline", pullback_logprob(spline_flow, target),
            pullback_logprob_batched(spline_flow, target), z, spline_step,
            len(spline_flow.bijector.bijectors), gen)
    normal = pp_standard_normal(gen)
    seconds = time.perf_counter() - t0
    launches = {k: funnel_n[k] + spline_n[k] for k in funnel_n}
    log("per_point: " + json.dumps(dict(
        seconds=seconds, launches=launches, funnel_ms_per_transition=dict(
            per_point=funnel_stats["ms_per_transition"],
            batched=funnel_stats["batched_ms_per_transition"]),
        spline_ms_per_transition=dict(
            per_point=spline_stats["ms_per_transition"],
            batched=spline_stats["batched_ms_per_transition"]),
        nuts_ms_per_transition=dict(
            per_point=nuts["ms_per_transition"],
            batched=nuts["batched_ms_per_transition"]),
        standard_normal_s=normal["seconds"])))
    return launches


# ----------------------------------------------------- free-energy phases
def fe_config(name, tmp, train=None, flow=None):
    """configs/<name>.yaml with its data and output paths rewritten into
    `tmp`, its lattice and EAM table paths made absolute, and the entries
    of `train` (depth cuts) over its train_parameters and of `flow` over
    its flow; returns the copy's path."""
    import yaml

    raw = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    for key in ("training_data", "testing_data"):
        if raw["dataset"].get(key):
            raw["dataset"][key] = str(tmp / "data" /
                                      Path(raw["dataset"][key]).name)
    for section in ("dataset", "prior"):
        for key in ("centers", "input_dir"):
            if isinstance(raw[section].get(key), str):
                raw[section][key] = str(ROOT / raw[section][key])
    raw["output"] = {k: f"{tmp / k}/" for k in (
        "training_dir", "testing_dir", "model_dir", "best_model_dir")}
    raw["train_parameters"].update(train or {})
    raw["flow"].update(flow or {})
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def depth_cut(label, what, value, uncut):
    """Print a depth cut on a line of its own (none if uncut). `uncut` is
    the config's (or the bench's) depth."""
    if value != uncut:
        log(f"depth cut: {label} {what} {value} (uncut: {uncut})")


class Step:
    """Runs one CLI main: its wall seconds (synchronised), what it printed,
    and the kernel launches it made."""

    def __init__(self, main, argv):
        import contextlib
        import io

        before = launch_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main([str(a) for a in argv])
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        self.printed = out.getvalue()
        log(self.printed.rstrip())
        if rc != 0:
            raise AssertionError(f"{main.__module__} {argv} exited {rc}")
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}

    def expect(self, label, accept_select=0, rqs=0, rqs_vjp=0):
        want = dict(accept_select=accept_select, accept_unfused=0, rqs=rqs,
                    rqs_vjp=rqs_vjp)
        if self.launches != want:
            raise AssertionError(f"{label}: launches {self.launches}, the "
                                 f"code implies {want}")


class SpanTimer:
    """Seconds spent inside functions swapped in place on their modules
    (synchronised at entry and exit), for a phase's breakdown."""

    def __init__(self, targets):
        self.targets = targets  # {label: (module, attribute)}
        self.seconds = dict.fromkeys(targets, 0.0)
        self.real = {}

    def _timed(self, label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds[label] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        for label, (module, name) in self.targets.items():
            self.real[label] = getattr(module, name)
            setattr(module, name, self._timed(label, self.real[label]))
        return self

    def __exit__(self, *exc):
        for label, (module, name) in self.targets.items():
            setattr(module, name, self.real[label])


def checkpoint_timer():
    """A SpanTimer over the training loop's checkpoint writes and copies."""
    from normalizingflow_tpu_torch.train import fused

    return SpanTimer({"save": (fused, "save_checkpoint"),
                      "copy": (fused, "copy_checkpoint")})


def data_transitions(nframes):
    """Transitions apps.sample_data runs for `nframes`: the warmup segment,
    then segments of at most SEGMENT draws, each draw `DATA_THIN`
    transitions, padded as run_hmc pads."""
    from normalizingflow_tpu_torch.apps.sample_data import SEGMENT
    from normalizingflow_tpu_torch.mcmc import padded_length

    draws = -(-nframes // DATA_CHAINS)
    segments = [min(SEGMENT, draws - done)
                for done in range(0, draws, SEGMENT)]
    return padded_length(DATA_WARMUP) + DATA_THIN * sum(
        padded_length(n) for n in segments)


def sample_launches(nsamples, layers, dim):
    """RQS launches of generate_from_nf: ceil(n/500) batches, each layer's
    SplineAR inverse one launch per coordinate."""
    return -(-nsamples // EVAL_BATCH) * layers * dim


def eval_launches(nsamples, layers):
    """RQS launches of evaluate: ceil(n/500) batches, one a layer."""
    return -(-nsamples // EVAL_BATCH) * layers


def chunk_logprobs(cfg):
    """(first, last) chunk's mean log-prob of a training run, from the
    losses its `.last` checkpoint keeps (log-prob = -loss)."""
    from normalizingflow_tpu_torch.apps.train import checkpoint_path
    from normalizingflow_tpu_torch.train.checkpoint import load_checkpoint

    losses = load_checkpoint(checkpoint_path(cfg) + ".last")["losses"]
    return -float(losses[0]), -float(losses[-1]), len(losses)


def estimates(path):
    """The four estimates and arrays apps.test / apps.fe wrote."""
    import numpy as np

    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def trained_layer_checks(flow, x, gen):
    """Each trained SplineAR's RQS kernels against the float64 plain
    versions on the layer's own w, h, d: forward from data frames `x`,
    inverse from the latents down, and the backward kernel on the forward's
    inputs with random cotangents. Returns (max |err| y, max |err| log-det,
    max |err| VJP, the latents)."""
    from normalizingflow_tpu_torch.ops.rqs import rqs_cuda, rqs_vjp_cuda

    layers = list(flow.bijector.bijectors)
    errs, vjp_errs = [], []
    with torch.no_grad():
        z, _ = flow.bijector.forward(x)
        for inverse, order in ((False, layers), (True, layers[::-1])):
            y = z if inverse else x
            for i, layer in enumerate(order):
                out, _ = layer.inverse(y) if inverse else layer.forward(y)
                w, h, d = layer.prep_spline(layer.raw_params(
                    out if inverse else y))
                b = layer.input_bounds + layer.output_bounds
                label = f"trained NSF_AR layer {i} inverse={inverse}"
                got = rqs_cuda(y, w, h, d, inverse, *b)
                errs.append(compare_rqs(*got, *plain64(y, w, h, d, inverse,
                                                       *b), label))
                if not inverse:
                    cot = [torch.randn(y.shape, device=y.device,
                                       generator=gen) for _ in range(2)]
                    vjp_errs.append(compare_vjp(
                        rqs_vjp_cuda(y, w, h, d, *cot, inverse, *b),
                        vjp64(y, w, h, d, *cot, inverse, *b), label))
                y = out
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            max(vjp_errs), z)


MBAR_CAPS = (500, 5000, 50000)  # 500: the solver's own cap (apps.test)


def mbar_study(out, n_particles, kT, label, tol):
    """emus against BAR on one fe_diff's work matrices (per particle, kT,
    the stability shift cancelling): MBAR's self-consistent iteration from
    0 stopped at each cap of MBAR_CAPS, and MBAR started at BAR's answer
    (state 1's reduced energies shifted by it). For two states MBAR's fixed
    point is BAR's; where the overlap is poor the iteration from 0 crawls
    toward it, 500 iterations fall short, and apps.test's emus (the
    reference's solver, capped at 500) is far from bar. Raises unless MBAR
    at the largest cap is nearer BAR than at 500 (or both within `tol` kT a
    particle: BAR stops at a relative change of 1e-5) and BAR's answer is
    MBAR's fixed point to `tol` kT a particle."""
    from normalizingflow_tpu_torch.estimators import bar, mbar

    q0, q1 = (torch.as_tensor(out[k], dtype=torch.float64)
              for k in ("Q0", "Q1"))
    n = q0.shape[0]
    u = -torch.cat([q0, q1]).T
    delta = float(bar(q0[:, 0] - q0[:, 1], -q1[:, 0] + q1[:, 1]))
    scale = kT / n_particles
    gaps = {cap: abs(float(mbar(u, [n, n], maximum_iterations=cap)[1])
                     - delta) * scale for cap in MBAR_CAPS}
    shifted = u.clone()
    shifted[1] -= delta
    from_bar = abs(float(mbar(shifted, [n, n])[1])) * scale
    check = dict(emus_minus_bar_by_cap=gaps, mbar_from_bar_minus_bar=from_bar,
                 tol=tol)
    log(f"{label}: MBAR against BAR: " + json.dumps(check))
    first, last = gaps[MBAR_CAPS[0]], gaps[MBAR_CAPS[-1]]
    if not (from_bar <= tol and (last < first or last <= tol)):
        raise AssertionError(f"{label}: MBAR does not approach BAR: {check}")
    return check


def fe_cli_phase(label, name, seed, nframes, train=None, mbar_tol=None,
                 record=None, then=None):
    """configs/<name>.yaml through apps.sample_data (`nframes` frames),
    apps.train (its train_parameters overridden by `train`), apps.test
    (with relaxation for the particle systems) and apps.fe testing, on a
    copy of the config whose paths point into a temporary directory.

    Gates: exact launch counts of every kernel at every step; data of the
    right shape, finite, inside +-L/2 where the target is periodic, at an
    acceptance in [0.5, 0.99]; the last training chunk's mean log-prob
    above the first's; four finite estimates and finite (relaxed) frames;
    with `mbar_tol`, MBAR approaching bar (mbar_study); each trained layer's
    RQS kernels against the float64 plain versions, and a round trip.
    Logs the phase's statistics (with `record`, the JAX package's) and
    returns (stats, launches by kernel, max |err| of the forward checks,
    max |err| of the VJP checks). `then(cfg)`, if given, runs last, while
    the trained model is still on disk."""
    import tempfile

    import numpy as np

    from normalizingflow_tpu_torch.apps import fe, fe_eval, sample_data
    from normalizingflow_tpu_torch.apps import test as app_test
    from normalizingflow_tpu_torch.apps import train as app_train
    from normalizingflow_tpu_torch.config import infer_boxlength, load_config
    from normalizingflow_tpu_torch.mcmc import relaxation
    from normalizingflow_tpu_torch.train import objectives

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config(name, tmp, train)
        cfg = load_config(cfg_path)
        ds, tp = cfg.dataset, cfg.train_parameters
        layers, dim = cfg.flow.nlayers, ds.nparticles * ds.dim
        _, box = infer_boxlength(ds)
        steps, rkl = tp.max_epochs, tp.rkl_finetune_steps
        relaxed = ds.potential in app_test.RELAXED_POTENTIALS
        reset_launch_counts()

        data = Step(sample_data.main, [cfg_path, nframes, "--seed", seed])
        transitions = data_transitions(nframes)
        data.expect(f"{label} sample_data", accept_select=transitions)
        accept = float(data.printed.split("HMC acceptance ")[1].split(")")[0])
        frames = np.concatenate([np.load(ds.training_data),
                                 np.load(ds.testing_data)])
        if frames.shape != (nframes, dim) or not np.isfinite(frames).all():
            raise AssertionError(f"{label} data: shape {frames.shape}, "
                                 f"finite {np.isfinite(frames).all()}")
        if relaxed and np.abs(frames).max() > box / 2 * (1 + 1e-6):
            raise AssertionError(f"{label} data outside +-L/2: "
                                 f"{np.abs(frames).max()} > {box / 2}")
        if not 0.5 <= accept <= 0.99:
            raise AssertionError(f"{label} data acceptance {accept}")

        # a training step runs each layer's forward and VJP kernels once; a
        # fine-tune step samples through the SplineAR inverse, one launch a
        # coordinate a layer, each with its VJP
        fine = SpanTimer({"rkl_finetune": (objectives, "rkl_finetune")})
        with checkpoint_timer() as ckpt, fine:
            trained = Step(app_train.main, [cfg_path])
        per_kernel = layers * (steps + rkl * dim)
        trained.expect(f"{label} train", rqs=per_kernel, rqs_vjp=per_kernel)
        first, last, chunks = chunk_logprobs(cfg)
        if not last > first:
            raise AssertionError(f"{label} training did not learn: chunk "
                                 f"log-prob {first} -> {last}")

        spans = SpanTimer({
            "relaxation": (relaxation, "relaxation_step"),
            "integrate_out_v": (relaxation, "integrate_out_v"),
            "estimators": (fe_eval, "_estimates")})
        with spans:
            test = Step(app_test.main, [cfg_path])
        # relaxed: integrate_out_v's one flat log_prob for each ensemble
        test.expect(f"{label} test", rqs=sample_launches(
            TEST_SAMPLES, layers, dim) + (2 * layers if relaxed else
                                          eval_launches(TEST_SAMPLES,
                                                        layers)))
        out = estimates(tmp / "testing_dir" / f"fe_{ds.name}.npz")
        four = {k: float(out[k]) for k in ("bar", "md", "nf", "emus")}
        if not all(math.isfinite(v) for v in four.values()):
            raise AssertionError(f"{label} estimates not finite: {four}")
        if not (np.isfinite(out["x0"]).all() and np.isfinite(out["x1"]).all()):
            raise AssertionError(f"{label}: a (relaxed) frame is not finite")
        mbar_check = (mbar_study(out, ds.nparticles, ds.kT, label, mbar_tol)
                      if mbar_tol is not None else None)

        fe_test = Step(fe.main, [cfg_path, "testing"])
        fe_test.expect(f"{label} fe testing", rqs=2 * (
            sample_launches(FE_SAMPLES, layers, dim)
            + eval_launches(FE_SAMPLES, layers)))
        rec = estimates(tmp / "testing_dir" / f"fe_{ds.name}_testing.npz")
        if not all(math.isfinite(float(rec[k])) for k in (
                "logp_generated", "logp_data")):
            raise AssertionError(f"{label}: fe testing log-densities not "
                                 f"finite")

        launches = {k: sum(s.launches[k] for s in (data, trained, test,
                                                   fe_test))
                    for k in ("accept_select", "rqs", "rqs_vjp")}
        flow, _, _ = app_test.load_trained(cfg)
        device = next(flow.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed + 3)
        x = torch.as_tensor(frames[:FE_CHECK_ROWS], device=device,
                            dtype=torch.float32)
        err_y, err_ld, err_vjp, z = trained_layer_checks(flow, x, gen)
        rt_z, rt_ld = round_trip(flow, z, label)
        n_params = sum(p.numel() for p in flow.parameters())
        del flow
        if then is not None:
            then(cfg)

    fine_s = fine.seconds["rkl_finetune"]
    stats = dict(
        config=name, dim=dim, layers=layers, bins=cfg.flow.nsplines,
        hidden=cfg.flow.hidden_dim, params=n_params, boxlength=box,
        frames=nframes, data_s=data.seconds, data_transitions=transitions,
        data_ms_per_transition=data.seconds * 1e3 / transitions,
        data_acceptance=accept, train_steps=steps,
        train_batch=tp.batch_size, train_s=trained.seconds - fine_s,
        train_ms_per_step=(trained.seconds - fine_s) * 1e3 / steps,
        train_chunks=chunks, train_checkpoint_s=sum(ckpt.seconds.values()),
        first_chunk_logprob=first, last_chunk_logprob=last,
        rkl_finetune_steps=rkl, rkl_finetune_s=fine_s,
        rkl_finetune_ms_per_step=fine_s * 1e3 / rkl if rkl else None,
        test_s=test.seconds, relaxed=relaxed,
        relaxation_s=spans.seconds["relaxation"]
        - spans.seconds["integrate_out_v"],
        integrate_out_v_s=spans.seconds["integrate_out_v"],
        estimators_s=spans.seconds["estimators"], **four,
        fe_testing_s=fe_test.seconds,
        logp_generated=float(rec["logp_generated"]),
        logp_data=float(rec["logp_data"]),
        fe_testing={k: float(rec[k]) for k in ("bar", "md", "nf", "emus")},
        mbar_check=mbar_check,
        launches=launches, max_abs_err_y=err_y, max_abs_err_ld=err_ld,
        max_abs_err_vjp=err_vjp, round_trip_z=rt_z, round_trip_log_det=rt_ld,
        jax_record=record)
    log(f"{label}: " + json.dumps(stats))
    return stats, launches, max(err_y, err_ld), err_vjp


def fe_lj_phase(seed):
    """configs/LJ.yaml through sample_data, train, test and fe testing; bar
    within JAX_BAR's fault-detecting bound of the JAX record; then the
    permutation diagnostic on the trained flow (lj_permutation_check),
    whose numbers and launches the result's "permutation" holds."""
    depth_cut("fe_lj", "train epochs", LJ_EPOCHS, 8000)
    permutation = {}
    stats, launches, err, err_vjp = fe_cli_phase(
        "fe_lj", "LJ", seed, FE_FRAMES, train={"max_epochs": LJ_EPOCHS},
        mbar_tol=0.05,
        record="BAR dF over 3 datasets 9.5778 +- 0.1195 kT/particle",
        then=lambda cfg: permutation.update(lj_permutation_check(cfg)))
    bar_gate("fe_lj", stats, "LJ", "a fault detector at the cut depth, "
             "not a hold on its bias")
    return dict(launches, max_abs_err=err, max_abs_err_vjp=err_vjp,
                permutation=permutation)


def lj_permutation_check(cfg):
    """tools/torch_lj_permutation.py's diagnose on the trained flow of
    `cfg` and its held-out frames: exact launches (the raw and relabeled
    frames' evaluation, as many generated draws), mean U of the raw and
    relabeled frames within ENERGY_TOL. Returns the numbers with their
    launches."""
    import numpy as np

    from normalizingflow_tpu_torch.apps.test import load_trained
    from tools import torch_lj_permutation

    flow, potential, cfg = load_trained(cfg)
    test = np.load(cfg.dataset.testing_data)
    reset_launch_counts()
    r = torch_lj_permutation.diagnose(flow, potential, test)
    r["launches"] = launch_counts()
    layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
    want = dict(accept_select=0, accept_unfused=0, rqs=2 * eval_launches(
        len(test), layers) + sample_launches(len(test), layers, dim),
        rqs_vjp=0)
    log("lj_permutation: " + json.dumps(r))
    log(torch_lj_permutation.report(r))
    if r["launches"] != want:
        raise AssertionError(f"lj_permutation: launches {r['launches']}, "
                             f"the code implies {want}")
    if not abs(r["u_raw"] - r["u_rel"]) <= ENERGY_TOL:
        raise AssertionError(f"lj_permutation: mean U {r['u_raw']} raw, "
                             f"{r['u_rel']} relabeled")
    return r


def bar_gate(label, stats, name, what=""):
    """|bar - the JAX record| within JAX_BAR's gate for `name`."""
    record, gate = JAX_BAR[name]
    gap = stats["bar"] - record
    log(f"{label}: bar {stats['bar']:.6f}, JAX record {record}, gap "
        f"{gap:+.6f} (gate {gate}{'; ' + what if what else ''})")
    if abs(gap) > gate:
        raise AssertionError(f"{label}: bar {stats['bar']} is {gap:+.4f} "
                             f"from the JAX record {record}, beyond the "
                             f"gate {gate}{' (' + what + ')' if what else ''}")


def fe_fe400k_phase(seed):
    """configs/Fe_400K.yaml (tabulated EAM) through the CLI mains."""
    depth_cut("fe_fe400k", "train epochs", FE_EPOCHS, 15000)
    stats, launches, err, err_vjp = fe_cli_phase(
        "fe_fe400k", "Fe_400K", seed, SLICE_FRAMES,
        train={"max_epochs": FE_EPOCHS}, mbar_tol=0.01,
        record="bar -4.083877 emus -4.08512 md -4.147069 nf -3.674463; "
               "bar over 3 data sets -4.08387 +- 0.000581")
    bar_gate("fe_fe400k", stats, "Fe_400K")
    return dict(launches, max_abs_err=err, max_abs_err_vjp=err_vjp)


def keep_phi4(cfg, keep):
    """The trained Phi4 flow's weights and training frames, copied into
    `keep` for the parallel phase; returns the config pointing there."""
    import dataclasses
    import shutil

    from normalizingflow_tpu_torch.apps.test import load_trained

    flow, _, _ = load_trained(cfg)
    torch.save(flow.state_dict(), keep / "phi4.pt")
    shutil.copyfile(cfg.dataset.training_data, keep / "phi4_train.npy")
    return dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, training_data=str(keep / "phi4_train.npy"),
        testing_data=None))


def fe_phi4_phase(seed, keep):
    """configs/Phi4.yaml: HMC data, forward KL then the reverse-KL
    fine-tune, test; then smc_phi4 on the trained flow, which is kept in
    `keep`. Returns (fe_phi4's launches and errors, smc_phi4's launches,
    the kept config)."""
    depth_cut("fe_phi4", "train epochs", PHI4_EPOCHS, 4000)
    depth_cut("fe_phi4", "rkl_finetune steps", PHI4_RKL_STEPS, 2000)
    smc = {}

    def then(cfg):
        smc.update(smc_phi4(cfg))
        smc["cfg"] = keep_phi4(cfg, keep)

    stats, launches, err, err_vjp = fe_cli_phase(
        "fe_phi4", "Phi4", seed, SLICE_FRAMES,
        train={"max_epochs": PHI4_EPOCHS,
               "rkl_finetune_steps": PHI4_RKL_STEPS},
        record="bar -1.059406 emus -1.059407 md -1.110401 nf -0.955755",
        then=then)
    gap = abs(stats["emus"] - stats["bar"])
    if gap > 0.01:
        raise AssertionError(f"fe_phi4: |emus - bar| = {gap} > 0.01")
    bar_gate("fe_phi4", stats, "Phi4")
    log(f"smc_phi4: mean dF/particle {smc['mean']:.6f}, the port's bar on "
        f"the same flow {stats['bar']:.6f}, gap "
        f"{smc['mean'] - stats['bar']:+.6f}")
    return (dict(launches, max_abs_err=err, max_abs_err_vjp=err_vjp),
            smc["launches"], smc["cfg"])


def phi4_smc(cfg, n_particles, seeds):
    """tools/phi4_smc.py's estimate on the trained flow of `cfg`: for each
    seed, flow_smc with the flow as proposal (SMC_MUTATIONS steps of
    SMC_LEAPFROG, step SMC_STEP); dF/particle = -log Z / (nparticles x
    dim), the flow density being normalized and kT 1. Returns a dict a
    seed."""
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.mcmc import flow_smc

    flow, potential, cfg = load_trained(cfg)
    device = next(flow.parameters()).device
    npart = cfg.dataset.nparticles * cfg.dataset.dim
    runs = []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(1000 + seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = flow_smc(gen, flow, potential, n_particles,
                       n_mutation_steps=SMC_MUTATIONS,
                       num_leapfrog=SMC_LEAPFROG, step_size=SMC_STEP,
                       device=device)
        log_z = float(res.log_evidence)  # waits for the device
        seconds = time.perf_counter() - t0
        runs.append(dict(
            seed=seed, log_z=log_z, stages=res.n_stages,
            final_accept=float(res.final_accept), df=-log_z / npart,
            seconds=seconds, s_per_stage=seconds / res.n_stages,
            finite=bool(torch.isfinite(res.particles).all())))
    return runs


def smc_profile(cfg):
    """device_idle of PROFILED stages of run_smc from SMC_PARTICLES draws
    of the trained flow (the draws made outside the profile)."""
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.mcmc import run_smc

    flow, potential, _ = load_trained(cfg)
    flow.requires_grad_(False)
    gen = torch.Generator(device=next(flow.parameters()).device)
    gen.manual_seed(999)
    with torch.no_grad():
        x0 = flow.sample(SMC_PARTICLES, generator=gen)[0]
    out = {}
    prof = device_idle(lambda: out.update(res=run_smc(
        gen, x0, flow.log_prob, potential.log_prob,
        n_mutation_steps=SMC_MUTATIONS, num_leapfrog=SMC_LEAPFROG,
        step_size=SMC_STEP, max_stages=PROFILED, device=x0.device)))
    return dict(stages=out["res"].n_stages, **prof)


def smc_phi4(cfg):
    """Flow-proposal SMC on the flow fe_phi4 trained, at tools/phi4_smc.py's
    width, SMC_SEEDS seeds. Gates: finite; each seed's dF/particle within
    SMC_GATE of the JAX record; exact launch counts (a seed: the initial
    flow.sample inverts column by column, one RQS launch a coordinate a
    layer; a stage evaluates the flow's log_prob once without gradient,
    then 1 + SMC_MUTATIONS x SMC_LEAPFROG times with its VJP, and launches
    the accept kernel once a mutation step)."""
    layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
    grads = 1 + SMC_MUTATIONS * SMC_LEAPFROG
    reset_launch_counts()
    runs = phi4_smc(cfg, SMC_PARTICLES, range(SMC_SEEDS))
    launches = launch_counts()
    stages = sum(r["stages"] for r in runs)
    want = dict(accept_select=SMC_MUTATIONS * stages, accept_unfused=0,
                rqs=layers * (SMC_SEEDS * dim + stages * (1 + grads)),
                rqs_vjp=layers * stages * grads)
    dfs = [r["df"] for r in runs]
    mean = statistics.fmean(dfs)
    std = statistics.pstdev(dfs)
    profiled = smc_profile(cfg)
    log("smc_phi4: " + json.dumps(dict(
        particles=SMC_PARTICLES, mutation_steps=SMC_MUTATIONS,
        leapfrog=SMC_LEAPFROG, step_size=SMC_STEP, runs=runs, mean=mean,
        std=std, launches=launches, profiled=profiled,
        jax_record=f"{JAX_SMC_DF} +- 0.0013 over 3 seeds")))
    if launches != want:
        raise AssertionError(f"smc_phi4: launches {launches}, the code "
                             f"implies {want}")
    for r in runs:
        if not (r["finite"] and math.isfinite(r["df"])
                and math.isfinite(r["final_accept"])):
            raise AssertionError(f"smc_phi4: non-finite output {r}")
        if abs(r["df"] - JAX_SMC_DF) > SMC_GATE:
            raise AssertionError(f"smc_phi4: seed {r['seed']} dF/particle "
                                 f"{r['df']} is more than {SMC_GATE} from "
                                 f"the JAX record {JAX_SMC_DF}")
    return dict(mean=mean, std=std, launches=launches)


def analytic_phase(label, name, epochs, record=None):
    """configs/<name>.yaml, whose target is a normalized density, so that
    the exact answer is 0: apps.train (`epochs` epochs, on the target's
    own samples), then apps.test. Gates: exact launch counts (a RealNVP
    flow launches none), four finite estimates, |bar| <= 0.05 and |emus -
    bar| <= 0.01. Logs the phase's statistics (with `record`, the JAX
    package's) and returns (the four estimates, launches by kernel)."""
    import tempfile

    from normalizingflow_tpu_torch.apps import test as app_test
    from normalizingflow_tpu_torch.apps import train as app_train
    from normalizingflow_tpu_torch.config import load_config

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config(name, tmp, {"max_epochs": epochs})
        cfg = load_config(cfg_path)
        layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
        spline_layers = layers if cfg.flow.type == "NSF_AR" else 0
        reset_launch_counts()
        with checkpoint_timer() as ckpt:
            train = Step(app_train.main, [cfg_path])
        train.expect(f"{label} train", rqs=spline_layers * epochs,
                     rqs_vjp=spline_layers * epochs)
        first, last, chunks = chunk_logprobs(cfg)
        test = Step(app_test.main, [cfg_path])
        test.expect(f"{label} test", rqs=sample_launches(
            TEST_SAMPLES, spline_layers, dim) + eval_launches(
                TEST_SAMPLES, spline_layers))
        out = estimates(tmp / "testing_dir" / f"fe_{cfg.dataset.name}.npz")
    four = {k: float(out[k]) for k in ("bar", "md", "nf", "emus")}
    launches = {k: train.launches[k] + test.launches[k]
                for k in ("accept_select", "rqs", "rqs_vjp")}
    stats = dict(config=name, flow=cfg.flow.type, dim=dim, layers=layers,
                 train_steps=epochs,
                 train_batch=cfg.train_parameters.batch_size,
                 train_s=train.seconds,
                 train_ms_per_step=train.seconds * 1e3 / epochs,
                 train_checkpoint_s=sum(ckpt.seconds.values()),
                 first_chunk_logprob=first, last_chunk_logprob=last,
                 train_chunks=chunks, test_s=test.seconds, **four,
                 launches=launches, jax_record=record)
    log(f"{label}: " + json.dumps(stats))
    if not all(math.isfinite(v) for v in four.values()):
        raise AssertionError(f"{label} estimates not finite: {four}")
    if not (abs(four["bar"]) <= 0.05
            and abs(four["emus"] - four["bar"]) <= 0.01):
        raise AssertionError(f"{label} off the exact 0: {four}")
    return four, launches


def fe_einstein_phase():
    """configs/Einstein.yaml: train on the analytic target, then test; md
    and nf also within 0.05 of bar."""
    depth_cut("fe_einstein", "train epochs", EINSTEIN_EPOCHS, 8000)
    four, launches = analytic_phase("fe_einstein", "Einstein",
                                    EINSTEIN_EPOCHS, JAX_RECORD["Einstein"])
    if not (abs(four["md"] - four["bar"]) <= 0.05
            and abs(four["nf"] - four["bar"]) <= 0.05):
        raise AssertionError(f"fe_einstein md or nf off bar: {four}")
    return launches


# ------------------------------------------------------------ field phases
def polymer_phase(seed):
    """configs/Polymer.yaml through apps.polymer data, training and
    testing; then each trained layer's RQS kernels against the float64
    plain versions on 100 held-out fields, and a round trip. Returns the
    launches by kernel and the checks' largest errors."""
    import tempfile

    import numpy as np

    from normalizingflow_tpu_torch.apps import polymer
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.config import config_device, load_config

    depth_cut("polymer", "training epochs", POLYMER_EPOCHS, 15000)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config("Polymer", tmp, {"max_epochs": POLYMER_EPOCHS})
        cfg = load_config(cfg_path)
        ds = cfg.dataset
        layers, dim = cfg.flow.nlayers, ds.nparticles * ds.dim
        reset_launch_counts()

        data = Step(polymer.main, [cfg_path, "data", SLICE_FRAMES])
        data.expect("polymer data")
        fields = np.concatenate([np.load(ds.training_data),
                                 np.load(ds.testing_data)])
        if fields.shape != (SLICE_FRAMES, dim) or \
                not np.isfinite(fields).all():
            raise AssertionError(f"polymer data: shape {fields.shape}")
        device = config_device(cfg)
        with torch.no_grad():
            action = polymer.surrogate(cfg, device).potential(
                torch.as_tensor(fields, device=device))
        # equipartition: E[S] = dim/2 for an exact Gaussian draw
        action_ratio = float(action.double().mean()) / (dim / 2)
        if abs(action_ratio - 1) > 0.01:
            raise AssertionError(f"polymer data: mean action / (dim/2) = "
                                 f"{action_ratio}")

        torch.cuda.reset_peak_memory_stats()
        with checkpoint_timer() as ckpt:
            trained = Step(polymer.main, [cfg_path, "training"])
        train_peak = torch.cuda.max_memory_allocated()
        per_kernel = layers * POLYMER_EPOCHS
        trained.expect("polymer training", rqs=per_kernel,
                       rqs_vjp=per_kernel)
        first, last, chunks = chunk_logprobs(cfg)

        test = Step(polymer.main, [cfg_path, "testing"])
        # two samplings of 100 (one launch a coordinate a layer) and one
        # evaluation batch of the held-out fields
        test.expect("polymer testing", rqs=2 * layers * dim + layers)
        rec = estimates(tmp / "testing_dir" /
                        f"polymer_{ds.name}_testing.npz")
        generated = np.load(tmp / "testing_dir" / "generated_fields.npy")

        flow, _, _ = load_trained(cfg)
        gen = torch.Generator(device=device).manual_seed(seed + 3)
        x = torch.as_tensor(fields[-polymer.NSAMPLES:], device=device,
                            dtype=torch.float32)
        err_y, err_ld, err_vjp, z = trained_layer_checks(flow, x, gen)
        rt_z, rt_ld = round_trip(flow, z, "polymer")
        del flow
    rec = {k: float(v) for k, v in rec.items()}
    launches = {k: sum(s.launches[k] for s in (data, trained, test))
                for k in ("accept_select", "rqs", "rqs_vjp")}
    stats = dict(
        dim=dim, layers=layers, hidden=cfg.flow.hidden_dim,
        frames=SLICE_FRAMES, data_s=data.seconds,
        mean_action_over_half_dim=action_ratio, train_steps=POLYMER_EPOCHS,
        train_batch=cfg.train_parameters.batch_size, train_s=trained.seconds,
        train_ms_per_step=(trained.seconds - sum(ckpt.seconds.values()))
        * 1e3 / POLYMER_EPOCHS,
        train_checkpoint_s=sum(ckpt.seconds.values()),
        train_peak_gb=train_peak / 1e9, train_chunks=chunks,
        first_chunk_logprob=first, last_chunk_logprob=last,
        test_s=test.seconds, **rec, generated_shape=list(generated.shape),
        launches=launches, max_abs_err_y=err_y, max_abs_err_ld=err_ld,
        max_abs_err_vjp=err_vjp, round_trip_z=rt_z, round_trip_log_det=rt_ld,
        jax_record="partial train only: logp_gen 53.34, held-out -3582.62")
    log("polymer: " + json.dumps(stats))
    if generated.shape != (polymer.NSAMPLES,) + polymer.field_shape(cfg) \
            or not np.isfinite(generated).all():
        raise AssertionError(f"polymer: generated fields "
                             f"{generated.shape}")
    if not all(math.isfinite(rec[k]) for k in (
            "logp_data", "logp_generated", "gap", "sample_s_hot",
            "sample_s_first")):
        raise AssertionError(f"polymer testing not finite: {rec}")
    return dict(launches, max_abs_err=max(err_y, err_ld),
                max_abs_err_vjp=err_vjp)


def polymer_rnvp_phase():
    """configs/Polymer_rnvp.yaml at full width through apps.polymer data and
    training (RNVP_STEPS forward-KL steps, checkpoints included). Gates: no
    kernel launches, an unrolled Chain, finite losses, and the Adam
    moment's dtype that the training reports equal to the memory policy's
    for the flow's parameter bytes on this card."""
    import tempfile

    from normalizingflow_tpu_torch.apps import polymer
    from normalizingflow_tpu_torch.bijectors import Chain, Repeat
    from normalizingflow_tpu_torch.config import (
        build_flow_stack,
        config_device,
        infer_boxlength,
        load_config,
    )
    from normalizingflow_tpu_torch.train.fused import adam_mu_dtype

    depth_cut("polymer_rnvp", "training steps", RNVP_STEPS, 15000)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config("Polymer_rnvp", tmp, {"max_epochs": RNVP_STEPS})
        cfg = load_config(cfg_path)
        # the CLI's flow, built on the meta device: its class and size
        stack = build_flow_stack(cfg, infer_boxlength(cfg.dataset)[0],
                                 device="meta", dtype=torch.float32)
        n_params = sum(p.numel() for p in stack.parameters())
        param_bytes = 4 * n_params
        device = config_device(cfg)
        policy = str(adam_mu_dtype(param_bytes, device)
                     or torch.float32).removeprefix("torch.")
        total = torch.cuda.mem_get_info(device)[1]
        reset_launch_counts()
        data = Step(polymer.main, [cfg_path, "data", 1000])
        data.expect("polymer_rnvp data")
        torch.cuda.reset_peak_memory_stats()
        with checkpoint_timer() as ckpt:
            trained = Step(polymer.main, [cfg_path, "training"])
        peak = torch.cuda.max_memory_allocated()
        trained.expect("polymer_rnvp training")
        first, last, chunks = chunk_logprobs(cfg)
    mu = trained.printed.split("Adam mu ")[1].split()[0]
    ckpt_s = sum(ckpt.seconds.values())
    stats = dict(
        layers=len(stack.bijectors), hidden=cfg.flow.hidden_dim,
        stack="Repeat" if isinstance(stack, Repeat) else "Chain",
        params=n_params, param_gb=param_bytes / 1e9, card_gb=total / 1e9,
        projected_residency_gb=4.25 * param_bytes / 1e9, adam_mu_dtype=mu,
        steps=RNVP_STEPS, batch=cfg.train_parameters.batch_size,
        data_s=data.seconds, train_s=trained.seconds,
        train_checkpoint_s=ckpt_s,
        train_ms_per_step=(trained.seconds - ckpt_s) * 1e3 / RNVP_STEPS,
        peak_gb=peak / 1e9, train_chunks=chunks, first_chunk_logprob=first,
        last_chunk_logprob=last,
        launches={k: data.launches[k] + trained.launches[k]
                  for k in ("accept_select", "rqs", "rqs_vjp")})
    log("polymer_rnvp: " + json.dumps(stats))
    log(f"polymer_rnvp: Adam mu dtype {mu} (the policy for "
        f"{param_bytes / 1e9:.2f} GB of params on a {total / 1e9:.1f} GB "
        f"card: {policy})")
    if not isinstance(stack, Chain) or isinstance(stack, Repeat):
        raise AssertionError("polymer_rnvp: expected an unrolled Chain")
    if mu != policy:
        raise AssertionError(f"polymer_rnvp: mu {mu}, the policy says "
                             f"{policy}")
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"polymer_rnvp log-probs {first}, {last}")
    return stats["launches"]


# ------------------------------------------------------------- parallel
def smc_stream(gen, n, dim, dtype, device):
    """run_smc's draws from `gen` for n particles, in its own order."""
    from normalizingflow_tpu_torch.mcmc.smc import generator_draws

    return generator_draws(gen, n, dim, SMC_MUTATIONS, dtype, device)


def hmc_stream(gen, n, dim, dtype, device):
    """run_hmc's draws from `gen`: one transition_draws a transition."""
    from normalizingflow_tpu_torch.mcmc import transition_draws

    while True:
        yield transition_draws(gen, n, dim, dtype, device)


def rows_of(stream, rows):
    """Each draw of a global stream cut to a rank's rows (u0 whole)."""
    for d in stream:
        yield d if isinstance(d, torch.Tensor) else tuple(t[rows] for t in d)


def phi4_model(cfg, keep, device):
    """The Phi4 flow that fe_phi4 trained (its weights kept in `keep`),
    with its target."""
    from normalizingflow_tpu_torch.config import setup_model

    flow, potential, _ = setup_model(cfg, device=device)
    flow.load_state_dict(torch.load(keep / "phi4.pt", map_location=device))
    return flow, potential


def funnel_model(keep, device):
    from normalizingflow_tpu_torch.targets import NealsFunnel

    flow = build_flow(None, device)
    flow.load_state_dict(torch.load(keep / "funnel.pt", map_location=device))
    flow.requires_grad_(False)
    return flow, NealsFunnel(DIM)


def par_latents(seed, device):
    """The SMC proposal's latents (SMC_PARTICLES, 64) and the funnel
    chains' start (CHAINS, DIM), the same on every rank."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z_smc = torch.randn(SMC_PARTICLES, DIM, generator=gen, device=device)
    z_hmc = torch.randn(CHAINS, DIM, generator=gen, device=device)
    return z_smc, z_hmc


def par_batches(data, seed, device):
    """PAR_TRAIN_STEPS batches of the config's 100 frames, the same on
    every rank."""
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    idx = torch.randint(0, data.shape[0], (PAR_TRAIN_STEPS, PAR_BATCH),
                        generator=gen, device=device)
    return [data[i] for i in idx]


def sample_in_blocks(flow, z):
    """flow.sample of the latents `z`, PAR_BLOCK rows a call: the rows a
    rank of two samples, so that every world size and the unsharded
    reference compute each row alike."""
    with torch.no_grad():
        return torch.cat([flow.sample(z=part)[0]
                          for part in z.split(PAR_BLOCK)])


def phi4_optimizer(flow, cfg):
    from normalizingflow_tpu_torch.train.loop import make_optimizer

    tp = cfg.train_parameters
    return make_optimizer(list(flow.parameters()), tp.learning_rate,
                          tp.scheduler, tp.lr_scheduler_gamma, tp.max_epochs)


def parallel_work(mesh, keep, cfg, seed, profile=False):
    """One rank's share of the parallel phase, on `mesh`: run_smc_sharded on
    the trained Phi4 flow, PAR_TRAIN_STEPS of make_sharded_train_step on its
    data (with `profile`, under device_idle), and run_hmc_sharded on the
    funnel pullback (a short run, then WARMUP + PAR_HMC_DRAWS). Every rank
    builds the same global inputs and draw streams and takes its rows.
    Returns this rank's results (CPU tensors), its launches by kernel and
    seconds by part."""
    import numpy as np

    from normalizingflow_tpu_torch.mcmc import (
        pullback_logprob_batched,
        push_to_data,
    )
    from normalizingflow_tpu_torch.parallel import (
        make_sharded_train_step,
        run_hmc_sharded,
        run_smc_sharded,
    )

    device = mesh.device
    flow, potential = phi4_model(cfg, keep, device)
    data = torch.as_tensor(np.load(keep / "phi4_train.npy"), device=device,
                           dtype=torch.float32)
    batches = par_batches(data, seed, device)
    funnel, target = funnel_model(keep, device)
    z_smc, z_hmc = par_latents(seed, device)
    smc_rows, hmc_rows = mesh.rows(SMC_PARTICLES), mesh.rows(CHAINS)
    out, seconds = {}, {}
    reset_launch_counts()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    flow.requires_grad_(False)
    x0 = mesh.all_gather(sample_in_blocks(flow, z_smc[smc_rows]))
    draws = rows_of(smc_stream(torch.Generator(device=device).manual_seed(
        seed + 1), SMC_PARTICLES, DIM, torch.float32, device), smc_rows)

    res = run_smc_sharded(mesh, None, x0, flow.log_prob, potential.log_prob,
                          n_mutation_steps=SMC_MUTATIONS,
                          num_leapfrog=SMC_LEAPFROG, step_size=SMC_STEP,
                          draws=draws)
    out["smc"] = dict(log_z=float(res.log_evidence), stages=res.n_stages,
                      final_accept=float(res.final_accept),
                      particles=res.particles.cpu())
    seconds["smc"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flow.requires_grad_(True)
    step = make_sharded_train_step(flow, phi4_optimizer(flow, cfg), mesh)
    losses = []

    def train():
        losses.extend(float(step(x)[0]) for x in batches)

    if profile:
        out["train_profiled"] = device_idle(train)
    else:
        train()
    out["train"] = dict(losses=losses, params=torch.cat(
        [p.detach().reshape(-1) for p in flow.parameters()]).cpu())
    seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    logp = pullback_logprob_batched(funnel, target)
    warm, draws_n = PAR_SHORT
    short = run_hmc_sharded(
        mesh, None, logp, z_hmc, draws_n, num_warmup=warm, step_size=0.5,
        num_leapfrog=LEAPFROG, draws=rows_of(hmc_stream(
            torch.Generator(device=device).manual_seed(seed + 2), CHAINS,
            DIM, torch.float32, device), hmc_rows))
    out["hmc_short"] = dict(samples=short.samples.cpu(),
                            step_size=float(short.step_size),
                            accept=float(short.accept_rate))
    full = run_hmc_sharded(
        mesh, None, logp, z_hmc, PAR_HMC_DRAWS, num_warmup=WARMUP,
        step_size=0.5, num_leapfrog=LEAPFROG, draws=rows_of(hmc_stream(
            torch.Generator(device=device).manual_seed(seed + 3), CHAINS,
            DIM, torch.float32, device), hmc_rows))
    # v of every rank's chains: (chains, draws) gathered over the ranks
    v = mesh.all_gather(push_to_data(funnel, full.samples)[..., 0].T
                        .contiguous())
    out["hmc_full"] = dict(
        accept=float(full.accept_rate), step_size=float(full.step_size),
        v_mean=float(v.mean()), v_var=float(v.var(correction=0)),
        finite=bool(torch.isfinite(v).all()))
    torch.cuda.synchronize()
    seconds["hmc"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["seconds"] = seconds
    return out


def par_expected(out, cfg, world):
    """The launches one rank's parallel_work implies: SMC samples its
    PAR_BLOCK-row blocks (one RQS launch a coordinate a layer each), then a
    stage evaluates the flow once without gradient and 1 + SMC_MUTATIONS x
    SMC_LEAPFROG times with its VJP, and launches the accept kernel once a
    mutation step; a training step runs each layer's forward and VJP once;
    the funnel's HMC launches the accept kernel once a transition."""
    from normalizingflow_tpu_torch.mcmc import padded_length

    layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
    stages = out["smc"]["stages"]
    grads = 1 + SMC_MUTATIONS * SMC_LEAPFROG
    blocks = SMC_PARTICLES // world // PAR_BLOCK
    transitions = sum(PAR_SHORT) + padded_length(WARMUP) \
        + padded_length(PAR_HMC_DRAWS)
    return dict(accept_select=SMC_MUTATIONS * stages + transitions,
                accept_unfused=0,
                rqs=layers * (blocks * dim + stages * (1 + grads)
                              + PAR_TRAIN_STEPS),
                rqs_vjp=layers * (stages * grads + PAR_TRAIN_STEPS))


class PartsMesh:
    """A one-process stand-in for a mesh of `world` ranks: no collective,
    but a mean over the chain axis sums each rank's block of rows, then
    the blocks in rank order, as the sharded run's SUM all-reduce does (at
    two ranks a + b, whichever rank adds), so that an unsharded run on it
    rounds as the sharded run."""

    size, rank = 1, 0

    def __init__(self, world):
        self.world = world

    def rows(self, n):
        return slice(0, n)

    def mean(self, x):
        parts = [p.sum(dim=0) for p in x.chunk(self.world)]
        return sum(parts[1:], parts[0]) / x.shape[0]

    def sum(self, t):
        return t.clone()

    def all_gather(self, x):
        return x

    def broadcast(self, t):
        return t.clone()


def par_reference(keep, cfg, seed, world, device):
    """The unsharded runs the sharded ones are held to, on the same inputs
    and draw streams, in one process: run_smc and the short run_hmc with
    their chain means in the ranks' order (PartsMesh), run_smc with
    torch.mean (the plain run, reported beside), and PAR_TRAIN_STEPS
    one-rank steps on the same batches with each batch's gradient
    accumulated over `world` equal parts, as the ranks split it (the mean
    of the parts' gradients; world 1: the whole batch)."""
    import numpy as np

    from normalizingflow_tpu_torch.mcmc import (
        pullback_logprob_batched,
        run_hmc,
        run_smc,
    )
    from normalizingflow_tpu_torch.train.objectives import forward_kl_loss

    flow, potential = phi4_model(cfg, keep, device)
    data = torch.as_tensor(np.load(keep / "phi4_train.npy"), device=device,
                           dtype=torch.float32)
    z_smc, z_hmc = par_latents(seed, device)
    flow.requires_grad_(False)
    x0 = sample_in_blocks(flow, z_smc)
    ref = {}
    for key, mesh in (("smc", PartsMesh(world)), ("smc_plain", None)):
        res = run_smc(torch.Generator(device=device).manual_seed(seed + 1),
                      x0, flow.log_prob, potential.log_prob,
                      n_mutation_steps=SMC_MUTATIONS,
                      num_leapfrog=SMC_LEAPFROG, step_size=SMC_STEP,
                      device=device, mesh=mesh)
        ref[key] = dict(log_z=float(res.log_evidence), stages=res.n_stages,
                        particles=res.particles.cpu())

    flow.requires_grad_(True)
    opt = phi4_optimizer(flow, cfg)
    params = list(flow.parameters())
    for x in par_batches(data, seed, device):
        grads = []
        for part in x.chunk(world):
            opt.zero_grad(set_to_none=True)
            forward_kl_loss(flow, part)[0].backward()
            grads.append([p.grad for p in params])
        for p, parts in zip(params, zip(*grads)):
            p.grad = sum(parts[1:], parts[0]) / world
        opt.step()
    ref["params"] = torch.cat([p.detach().reshape(-1)
                               for p in params]).cpu()

    funnel, target = funnel_model(keep, device)
    warm, draws_n = PAR_SHORT
    short = run_hmc(torch.Generator(device=device).manual_seed(seed + 2),
                    pullback_logprob_batched(funnel, target), z_hmc, draws_n,
                    num_warmup=warm, step_size=0.5, num_leapfrog=LEAPFROG,
                    device=device, mesh=PartsMesh(world))
    ref["hmc_short"] = dict(samples=short.samples.cpu(),
                            step_size=float(short.step_size))
    return ref


def par_compare(label, ranks, ref, cfg, world):
    """Gates of one world size's ranks against the unsharded reference
    (par_reference): exact launch counts on every rank; the global
    statistics and parameters identical on every rank; SMC with the
    reference's stages, log-evidence within PAR_LOGZ_RTOL and dF/particle
    within SMC_GATE of the JAX record (the plain run's stages and
    log-evidence are reported beside); parameters within PAR_PARAM_TOL of
    the one-rank steps; the short HMC run's step size within PAR_HMC_RTOL
    and its chains within PAR_CHAIN_TOL of the reference (all but
    PAR_CHAIN_SHARE of them); the funnel's gates over the full run. Returns
    the statistics it logs."""
    npart = cfg.dataset.nparticles * cfg.dataset.dim
    smc = ranks[0]["smc"]
    particles = torch.cat([r["smc"]["particles"] for r in ranks])
    params = ranks[0]["train"]["params"]
    short = torch.cat([r["hmc_short"]["samples"] for r in ranks], dim=1)
    chain_err = (short - ref["hmc_short"]["samples"]).abs().amax(dim=(0, 2))
    stats = dict(
        world=world, smc_stages=smc["stages"], smc_log_z=smc["log_z"],
        smc_df=-smc["log_z"] / npart, ref_log_z=ref["smc"]["log_z"],
        smc_log_z_rel=abs(smc["log_z"] / ref["smc"]["log_z"] - 1),
        smc_particles_max_diff=float(
            (particles - ref["smc"]["particles"]).abs().max()),
        smc_final_accept=smc["final_accept"],
        plain_smc_stages=ref["smc_plain"]["stages"],
        plain_smc_log_z_rel=abs(smc["log_z"] / ref["smc_plain"]["log_z"]
                                - 1),
        train_losses=ranks[0]["train"]["losses"],
        train_params_max_diff=float((params - ref["params"]).abs().max()),
        hmc_short_step_rel=abs(ranks[0]["hmc_short"]["step_size"]
                               / ref["hmc_short"]["step_size"] - 1),
        hmc_short_chains_within=float((chain_err <= PAR_CHAIN_TOL)
                                      .double().mean()),
        hmc_short_max_diff=float(chain_err.max()),
        hmc_full=ranks[0]["hmc_full"],
        launches=[r["launches"] for r in ranks],
        seconds=[r["seconds"] for r in ranks],
        train_profiled=ranks[0].get("train_profiled"))
    log(f"{label}: " + json.dumps(stats))
    for r in ranks:
        want = par_expected(r, cfg, world)
        if r["launches"] != want:
            raise AssertionError(f"{label}: launches {r['launches']}, the "
                                 f"code implies {want}")
        for key in ("smc", "hmc_full"):
            others = {k: v for k, v in r[key].items() if k != "particles"}
            mine = {k: v for k, v in ranks[0][key].items()
                    if k != "particles"}
            if others != mine:
                raise AssertionError(f"{label}: {key} differs across ranks")
        if not torch.equal(r["train"]["params"], params):
            raise AssertionError(f"{label}: parameters differ across ranks")
    if smc["stages"] != ref["smc"]["stages"] or \
            stats["smc_log_z_rel"] > PAR_LOGZ_RTOL:
        raise AssertionError(f"{label}: SMC off the unsharded run: {stats}")
    if abs(stats["smc_df"] - JAX_SMC_DF) > SMC_GATE or \
            not bool(torch.isfinite(particles).all()):
        raise AssertionError(f"{label}: SMC dF/particle {stats['smc_df']} "
                             f"more than {SMC_GATE} from {JAX_SMC_DF}")
    if stats["train_params_max_diff"] > PAR_PARAM_TOL or \
            not all(math.isfinite(x) for x in stats["train_losses"]):
        raise AssertionError(f"{label}: training off the one-rank steps")
    if stats["hmc_short_step_rel"] > PAR_HMC_RTOL or \
            stats["hmc_short_chains_within"] < 1 - PAR_CHAIN_SHARE:
        raise AssertionError(f"{label}: short HMC run off the unsharded")
    full = stats["hmc_full"]
    if not (full["finite"] and 0.6 <= full["accept"] <= 0.95
            and abs(full["v_mean"]) < 0.15 and abs(full["v_var"] - 9) < 0.9):
        raise AssertionError(f"{label}: funnel gates failed: {full}")
    return stats


def _par_rank(rank, world, keep, cfg, seed):
    """A spawned rank of the two-rank run: gloo over CUDA tensors on the
    one card; its results go to keep/w<world>_<rank>.pt."""
    import torch.distributed as dist

    from normalizingflow_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{keep}/gloo_store",
                            world_size=world, rank=rank)
    try:
        out = parallel_work(make_mesh(), keep, cfg, seed)
        torch.save(out, keep / f"w{world}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def profile_trace(keep, seed, device):
    """utils.profiling.trace around two funnel transitions: the Chrome
    trace it writes must name the accept kernel, the matmuls and the
    annotated range."""
    from normalizingflow_tpu_torch.mcmc import (
        pullback_logprob_batched,
        run_hmc,
    )
    from normalizingflow_tpu_torch.utils import annotate, trace

    funnel, target = funnel_model(keep, device)
    z = par_latents(seed, device)[1]
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    with trace(str(keep / "trace")):
        with annotate("funnel_transitions"):
            run_hmc(gen, pullback_logprob_batched(funnel, target), z, 2,
                    num_warmup=0, step_size=0.5, num_leapfrog=LEAPFROG,
                    device=device)
            torch.cuda.synchronize()
    (path,) = (keep / "trace").glob("trace_*.json")
    text = path.read_text()
    names = {"accept kernel": "hmc_accept_kernel", "matmul": "gemm",
             "annotation": "funnel_transitions"}
    found = {k: v in text for k, v in names.items()}
    log(f"profiling: trace {path.stat().st_size / 1e6:.2f} MB, names "
        + json.dumps(found))
    if not all(found.values()):
        raise AssertionError(f"profiling: the trace lacks {found}")


def elementary_phase():
    """configs/Gaussian_rnvp.yaml with its flow replaced by each of Planar,
    Radial and OneByOneConv: apps.train for ELEMENTARY_EPOCHS (two chunks);
    gates: no kernel launch, the second chunk's mean log-prob above the
    first's, and for Radial and OneByOneConv a round trip on the card
    (Planar has no inverse)."""
    from normalizingflow_tpu_torch.apps import train as app_train
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.config import load_config

    depth_cut("elementary", "train epochs", ELEMENTARY_EPOCHS, 3000)
    stats = {}
    for kind in ELEMENTARY:
        with tempfile.TemporaryDirectory() as tmpdir:
            tmp = Path(tmpdir)
            cfg_path = fe_config("Gaussian_rnvp", tmp,
                                 {"max_epochs": ELEMENTARY_EPOCHS},
                                 flow={"type": kind})
            cfg = load_config(cfg_path)
            reset_launch_counts()
            trained = Step(app_train.main, [cfg_path])
            trained.expect(f"elementary {kind}")
            first, last, chunks = chunk_logprobs(cfg)
            rt = None
            if kind != "Planar":
                flow, potential, _ = load_trained(cfg)
                x = potential.sample(4096, generator=torch.Generator(
                    device=next(flow.parameters()).device).manual_seed(7))
                with torch.no_grad():
                    z = flow.bijector.forward(x)[0]
                rt = round_trip(flow, z, kind)
        stats[kind] = dict(train_s=trained.seconds,
                           ms_per_step=trained.seconds * 1e3
                           / ELEMENTARY_EPOCHS, first_chunk_logprob=first,
                           last_chunk_logprob=last, chunks=chunks,
                           round_trip=rt)
        if not (math.isfinite(last) and last > first):
            raise AssertionError(f"elementary {kind}: chunk log-prob "
                                 f"{first} -> {last}")
    log("elementary: " + json.dumps(stats))
    return stats


def parallel_phase(keep, cfg, seed):
    """The multi-device layer on the card: parallel_work at NCCL world size
    1 in this process, then over two gloo ranks on the one card (NCCL
    refuses two ranks on one GPU), spawned from here with the kernels
    already built; each against the unsharded reference (par_compare).
    Then the trace and the elementary flows. Returns the launches by world
    size, summed over the ranks."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from normalizingflow_tpu_torch.parallel import make_mesh

    depth_cut("parallel", "funnel HMC draws", PAR_HMC_DRAWS, FULL_DRAWS)
    depth_cut("parallel", "Phi4 train steps", PAR_TRAIN_STEPS, 4000)
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{keep}/nccl_store",
                            world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        w1 = parallel_work(make_mesh(), keep, cfg, seed, profile=True)
        w1_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    stats = dict(w1=par_compare("parallel_w1", [w1],
                                par_reference(keep, cfg, seed, 1, "cuda"), cfg,
                                1))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_par_rank, args=(PAR_WORLD, keep, cfg, seed), nprocs=PAR_WORLD)
    w2_s = time.perf_counter() - t0
    ranks = [torch.load(keep / f"w{PAR_WORLD}_{r}.pt")
             for r in range(PAR_WORLD)]
    stats["w2"] = par_compare(f"parallel_w{PAR_WORLD}", ranks,
                              par_reference(keep, cfg, seed, PAR_WORLD,
                                            "cuda"), cfg, PAR_WORLD)
    profile_trace(keep, seed, "cuda")
    elementary = elementary_phase()
    log("parallel: " + json.dumps(dict(
        w1_s=w1_s, w2_spawn_s=w2_s, phase_s=time.perf_counter() - t_phase,
        elementary_s=sum(e["train_s"] for e in elementary.values()))))
    return {"parallel_w1": w1["launches"],
            f"parallel_w{PAR_WORLD}": {k: sum(r["launches"][k]
                                              for r in ranks)
                                       for k in w1["launches"]}}


def jax_resume_phase():
    """configs/Gaussian_rnvp.yaml: the JAX package's training state at
    epoch JAX_EPOCH continued by apps.train --resume to the config's
    epochs, then apps.test on the port's `.pt`; the gates of the module
    docstring's phase 13. Returns the launches by kernel."""
    from normalizingflow_tpu_torch.apps import test as app_test
    from normalizingflow_tpu_torch.apps import train as app_train
    from normalizingflow_tpu_torch.config import load_config
    from normalizingflow_tpu_torch.train.checkpoint import (
        load_checkpoint,
        read_jax_checkpoint,
    )

    t_phase = time.perf_counter()
    fixture_losses = [float(v) for v in
                      read_jax_checkpoint(JAX_FIXTURE)["losses"]]
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config("Gaussian_rnvp", tmp)
        cfg = load_config(cfg_path)
        name, epochs = cfg.dataset.name, cfg.train_parameters.max_epochs
        model_dir = Path(cfg.output.model_dir)
        model_dir.mkdir(parents=True)
        shutil.copyfile(JAX_FIXTURE, model_dir / f"{name}.msgpack.last")
        reset_launch_counts()
        train = Step(app_train.main, [cfg_path, "--resume"])
        train.expect("jax_resume train")
        written = sorted(p.name for p in model_dir.iterdir())
        losses = [float(v) for v in load_checkpoint(
            str(model_dir / f"{name}.pt.last"))["losses"]]
        test = Step(app_test.main, [cfg_path])
        test.expect("jax_resume test")
        out = estimates(tmp / "testing_dir" / f"fe_{name}.npz")
    four = {k: float(out[k]) for k in ("bar", "md", "nf", "emus")}
    launches = {k: train.launches[k] + test.launches[k]
                for k in ("accept_select", "rqs", "rqs_vjp")}
    steps = epochs - JAX_EPOCH
    new_chunks = -(-steps // 500)  # apps.train's chunks of 500 steps
    stats = dict(config="Gaussian_rnvp", flow=cfg.flow.type,
                 layers=cfg.flow.nlayers, hidden=cfg.flow.hidden_dim,
                 fixture_epoch=JAX_EPOCH, max_epochs=epochs,
                 fixture_last_loss=fixture_losses[-1],
                 first_resumed_loss=losses[len(fixture_losses)],
                 losses=losses, written=written, train_s=train.seconds,
                 train_ms_per_step=train.seconds * 1e3 / steps,
                 test_s=test.seconds, **four, launches=launches,
                 phase_s=time.perf_counter() - t_phase)
    log("jax_resume: " + json.dumps(stats))
    if f"{name}.msgpack.last at epoch {JAX_EPOCH}" not in train.printed:
        raise AssertionError("jax_resume: apps.train did not resume the "
                             "JAX checkpoint at its epoch")
    if losses[:len(fixture_losses)] != fixture_losses or len(losses) != \
            len(fixture_losses) + new_chunks:
        raise AssertionError(f"jax_resume: losses {losses}, the fixture's "
                             f"{fixture_losses} + {new_chunks} chunks")
    if not abs(stats["first_resumed_loss"] - fixture_losses[-1]) \
            <= RESUME_GAP:
        raise AssertionError(f"jax_resume: the first resumed chunk "
                             f"{stats['first_resumed_loss']} is not within "
                             f"{RESUME_GAP} of {fixture_losses[-1]}")
    if not {f"{name}.pt", f"{name}.pt.last"} <= set(written):
        raise AssertionError(f"jax_resume: model_dir holds {written}")
    if not all(math.isfinite(v) for v in four.values()):
        raise AssertionError(f"jax_resume estimates not finite: {four}")
    if not (abs(four["bar"]) <= 0.05
            and abs(four["emus"] - four["bar"]) <= 0.01):
        raise AssertionError(f"jax_resume off the exact 0: {four}")
    return launches


def parity_phase(seed, epochs=PARITY_EPOCHS):
    """configs/Gaussian.yaml through tools/torch_parity.py's run_config and
    its in-process runner (train, apps.fe testing, apps.test) at `epochs`,
    the gates of the module docstring's phase 14. Returns the launches by
    kernel and the trained-layer checks' largest errors."""
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.config import load_config
    from tools import torch_parity

    depth_cut("parity", "train epochs", epochs, 3000)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        reset_launch_counts()
        row = torch_parity.run_config(
            "Gaussian", root=Path(tmpdir), runner=torch_parity.run_in_process,
            overrides={"train_parameters": {"max_epochs": epochs}})
        launches = launch_counts()
        if not row["steps"]["train"]["ok"]:
            raise AssertionError(f"parity: training failed: "
                                 f"{row['steps']['train'].get('tail')}")
        cfg = load_config(Path(tmpdir) / "configs" / "Gaussian.yaml")
        flow, potential, _ = load_trained(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed + 3)
        x = potential.sample(FE_SAMPLES, generator=gen).reshape(
            FE_SAMPLES, -1).float()
        err_y, err_ld, err_vjp, z = trained_layer_checks(flow, x, gen)
        rt_z, rt_ld = round_trip(flow, z, "parity")
        del flow
    layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
    # a training step: each layer's forward and VJP; apps.fe testing: its
    # 2000 draws and 2000 target samples, then fe_diff's (no run_* data
    # sets); apps.test: fe_diff's 500 and 500
    trained = layers * epochs
    want = dict(accept_select=0, accept_unfused=0, rqs=trained + 2 * (
        sample_launches(FE_SAMPLES, layers, dim)
        + eval_launches(FE_SAMPLES, layers)) + sample_launches(
            TEST_SAMPLES, layers, dim) + eval_launches(TEST_SAMPLES, layers),
        rqs_vjp=trained)
    status = torch_parity.status_of(row)
    stats = dict(
        config="Gaussian", flow=cfg.flow.type, layers=layers, dim=dim,
        bins=cfg.flow.nsplines, train_steps=epochs, status=status,
        card=row.get("card"),
        steps={k: v["seconds"] for k, v in row["steps"].items()},
        **{k: row.get(k) for k in ("best_logprob", "logp_gen", "logp_test",
                                   "bar", "md", "nf", "emus")},
        launches=launches, row_launches=row.get("launches"),
        max_abs_err_y=err_y, max_abs_err_ld=err_ld, max_abs_err_vjp=err_vjp,
        round_trip_z=rt_z, round_trip_log_det=rt_ld,
        phase_s=time.perf_counter() - t_phase)
    log("parity: " + json.dumps(stats))
    if launches != want or row.get("launches") != want:
        raise AssertionError(f"parity: launches {launches} (the row's "
                             f"{row.get('launches')}), the code implies "
                             f"{want}")
    if status != "ok":
        raise AssertionError(f"parity: status_of reads {status!r}")
    if not abs(row["bar"]) <= 0.05:
        raise AssertionError(f"parity: bar {row['bar']} off the exact 0")
    return dict({k: launches[k] for k in ("accept_select", "rqs", "rqs_vjp")},
                max_abs_err=max(err_y, err_ld), max_abs_err_vjp=err_vjp)


def fit_studies_phase(seed, permutation):
    """The module docstring's phase 15; `permutation` is what fe_lj's
    lj_permutation_check returned. Returns the launches by kernel of the
    three studies."""
    import dataclasses

    import numpy as np

    from normalizingflow_tpu_torch.config import load_config, setup_model
    from tools import torch_fit_sweep, torch_gm_fit_sweep

    depth_cut("fit_studies", "rkl variant train epochs", FIT_EPOCHS, 3000)
    depth_cut("fit_studies", "rkl fine-tune steps", FIT_RKL_STEPS,
              torch_fit_sweep.VARIANTS["rkl"][2])
    depth_cut("fit_studies", "gm ref epochs", GM_EPOCHS,
              torch_gm_fit_sweep.REFERENCE["max_epochs"])
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg = load_config(fe_config("Gaussian", tmp,
                                    {"max_epochs": FIT_EPOCHS}))
        _, target, _ = setup_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed + 4)
        np.save(tmp / "test.npy",
                target.sample(FE_SAMPLES, generator=gen).cpu().numpy())
        cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
            cfg.dataset, testing_data=str(tmp / "test.npy")))
        reset_launch_counts()
        row = torch_fit_sweep.run_variant("rkl", cfg, {}, {}, FIT_RKL_STEPS)
        fit = launch_counts()
    layers, dim = cfg.flow.nlayers, cfg.dataset.nparticles * cfg.dataset.dim
    # a training step: each layer's forward and VJP; a fine-tune step: the
    # inverse, a launch a coordinate a layer, each with its VJP; then the
    # held-out gap's 2000 draws and 2000 frames
    steps = layers * (FIT_EPOCHS + FIT_RKL_STEPS * dim)
    want_fit = dict(accept_select=0, accept_unfused=0, rqs=steps + (
        sample_launches(FE_SAMPLES, layers, dim)
        + eval_launches(FE_SAMPLES, layers)), rqs_vjp=steps)

    reset_launch_counts()
    gm_row = torch_gm_fit_sweep.run("ref", {"max_epochs": GM_EPOCHS})
    gm = launch_counts()
    gm_cfg = torch_gm_fit_sweep.configure({"max_epochs": GM_EPOCHS})
    gm_layers = gm_cfg.flow.nlayers
    gm_dim = gm_cfg.dataset.nparticles * gm_cfg.dataset.dim
    # the 2000 flow draws in one batch, then the target draws' log-density
    want_gm = dict(accept_select=0, accept_unfused=0, rqs=gm_layers * (
        GM_EPOCHS + gm_dim + 1), rqs_vjp=gm_layers * GM_EPOCHS)

    stats = dict(
        rkl_variant={k: row[k] for k in (
            "epochs", "rkl_steps", "rkl_final_loss", "best_logprob",
            "logp_gen", "logp_heldout", "gap_per_ptcl", "train_s")},
        gm_ref={k: gm_row[k] for k in (
            "overrides", "logp_gen", "logp_test", "gap", "rev_zwanzig_nf",
            "train_s")},
        permutation={k: permutation.get(k) for k in (
            "frames", "n_permuted", "mean_moved", "u_raw", "u_rel",
            "logp_gen", "logp_raw", "logp_rel", "recovered_pct")},
        launches=dict(rkl_variant=fit, gm_ref=gm,
                      permutation=permutation.get("launches")),
        phase_s=time.perf_counter() - t_phase)
    log("fit_studies: " + json.dumps(stats))
    log(f"fit_studies: LJ permutation recovered "
        f"{permutation['recovered_pct']:.1f}% of the held-out gap")
    for label, got, want, own in (("rkl variant", fit, want_fit,
                                   row["launches"]),
                                  ("gm ref", gm, want_gm, gm_row["launches"])):
        if got != want or own != want:
            raise AssertionError(f"fit_studies {label}: launches {got} (the "
                                 f"row's {own}), the code implies {want}")
    if not (math.isfinite(row["rkl_final_loss"])
            and abs(row["gap_per_ptcl"]) <= 0.05):
        raise AssertionError(f"fit_studies: rkl variant gap "
                             f"{row['gap_per_ptcl']} a particle, final "
                             f"reverse KL {row['rkl_final_loss']}")
    if not abs(gm_row["rev_zwanzig_nf"]) <= 0.05:
        raise AssertionError(f"fit_studies: gm ref nf "
                             f"{gm_row['rev_zwanzig_nf']} off the exact 0")
    paths = (fit, gm, permutation["launches"])
    return {k: sum(p[k] for p in paths)
            for k in ("accept_select", "rqs", "rqs_vjp")}

# -------------------------------------------------------------------- vi
def vi_flow(layers, dim, device):
    from normalizingflow_tpu_torch import NormalizingFlow
    from normalizingflow_tpu_torch.bijectors import Chain
    from normalizingflow_tpu_torch.distributions import DiagNormal

    return NormalizingFlow(DiagNormal(dim, device=device,
                                      dtype=torch.float32), Chain(layers))


def vi_spline_flow(size, gen, device):
    """tests/test_vi.py's config-3 stack at `size` particles of 2
    coordinates: 2 x SplineCoupling (K 8, B 4, hidden 32, masks (0,), (1,))
    + InvertibleLinear."""
    from normalizingflow_tpu_torch.bijectors import (
        InvertibleLinear,
        SplineCoupling,
    )

    kw = dict(generator=gen, device=device, dtype=torch.float32)
    return vi_flow([SplineCoupling(size, 2, num_bins=8, tail_bound=4.0,
                                   hidden_dim=32, mask=(a,), **kw)
                    for a in range(2)]
                   + [InvertibleLinear(2 * size, **kw)], 2 * size, device)


def vi_fit(flow, loss_fn, steps, lr):
    """tests/test_vi.py's loop: `steps` Adam updates at the constant rate
    `lr` of loss_fn(). Returns the losses (read once, at the end) and the
    seconds (synchronised)."""
    from normalizingflow_tpu_torch.train.loop import Adam

    opt = Adam(list(flow.parameters()), lambda count: lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    return torch.stack(losses).tolist(), time.perf_counter() - t0, step


def vi_spline(label, size, sample, cov, gen, device, gates):
    """The config-3 stack fitted to the target that `sample(n)` draws from
    (cov its covariance, numpy): VI_SPLINE_STEPS forward-KL steps, then
    VI_SAMPLES draws and their round trip; `gates(stats, x)` raises on a
    miss. Returns the fit's record and the step function (the next update
    of the trained flow)."""
    from normalizingflow_tpu_torch.train.objectives import forward_kl_loss
    from tools.vi_moments import vi_stats

    depth_cut(f"vi {label}", "train steps", VI_SPLINE_STEPS, 500)
    flow = vi_spline_flow(size, gen, device)
    (losses, secs, step), fit = launched(lambda: vi_fit(
        flow, lambda: forward_kl_loss(flow, sample(VI_DRAWS))[0],
        VI_SPLINE_STEPS, VI_SPLINE_LR))
    expect_launches(f"vi {label} fit", fit, 0, 2 * VI_SPLINE_STEPS)

    def draws():
        with torch.no_grad():
            x, _, z = flow.sample(VI_SAMPLES, generator=gen)
            z2 = flow.forward(x)[0]
        return x, z, z2

    (x, z, z2), drawn = launched(draws)
    # the inverse and the forward of both coupling layers, no gradient
    want = dict(accept_select=0, accept_unfused=0, rqs=4, rqs_vjp=0)
    if drawn != want:
        raise AssertionError(f"vi {label} draws: launches {drawn}, the code "
                             f"implies {want}")
    stats = dict(vi_stats(x.cpu().numpy(), cov),
                 rt=float((z2 - z).abs().max()),
                 finite=bool(torch.isfinite(x).all()))
    rec = dict(size=size, steps=VI_SPLINE_STEPS, first_loss=losses[0],
               final_loss=losses[-1], train_s=secs,
               ms_per_step=secs * 1e3 / VI_SPLINE_STEPS, **stats,
               launches={k: fit[k] + drawn[k] for k in fit})
    log(f"vi: {label} " + json.dumps(rec))
    if not (stats["finite"] and math.isfinite(losses[-1])):
        raise AssertionError(f"vi {label}: non-finite draws or loss")
    if not stats["rt"] <= VI_RT_TOL:
        raise AssertionError(f"vi {label}: round trip off by {stats['rt']}")
    gates(stats, x)
    return rec, step


def vi_phase(seed):
    """The module docstring's phase 17. Returns the launches by kernel."""
    import numpy as np

    from normalizingflow_tpu_torch.bijectors import (
        ActNorm,
        Invert,
        Planar,
        Radial,
    )
    from normalizingflow_tpu_torch.device import entry_device
    from normalizingflow_tpu_torch.distributions import GaussianMixture
    from normalizingflow_tpu_torch.targets import Banana, CorrelatedGaussian
    from normalizingflow_tpu_torch.train.objectives import elbo, reverse_kl
    from tools.vi_moments import banana_cov

    device = entry_device()
    kw = dict(device=device, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed + 16)
    t_phase = time.perf_counter()
    stats = {}

    # (i) config 2: no kernel on these flows
    before = launch_counts()
    depth_cut("vi planar", "train steps", VI_PLANAR_STEPS, 800)
    planar_target = CorrelatedGaussian(2, 0.7, **kw)
    planar = vi_flow([Invert(Planar(2, generator=gen, **kw))
                      for _ in range(8)], 2, device)
    losses, secs, planar_step = vi_fit(
        planar, lambda: reverse_kl(planar, planar_target, VI_DRAWS,
                                   generator=gen), VI_PLANAR_STEPS, VI_LR)
    with torch.no_grad():
        x = planar.sample(VI_COV_DRAWS, generator=gen)[0]
    cov = np.cov(x.double().cpu().numpy().T)
    cov_err = float(np.abs(cov - planar_target.cov.double().cpu().numpy())
                    .max())
    stats["planar"] = dict(first_loss=losses[0], final_loss=losses[-1],
                           cov=cov.tolist(), cov_err=cov_err, train_s=secs,
                           ms_per_step=secs * 1e3 / VI_PLANAR_STEPS)

    depth_cut("vi radial", "train steps", VI_RADIAL_STEPS, 600)
    gm = GaussianMixture([[1.0, 1.0]], [0.5], npoints=1, point_dim=2, **kw)
    radial = vi_flow([Radial(2, generator=gen, **kw) for _ in range(6)], 2,
                     device)
    losses, secs, _ = vi_fit(
        radial, lambda: reverse_kl(radial, gm, VI_DRAWS, generator=gen),
        VI_RADIAL_STEPS, VI_LR)
    with torch.no_grad():
        mean = radial.sample(VI_COV_DRAWS, generator=gen)[0].double().mean(0)
    stats["radial"] = dict(first_loss=losses[0], final_loss=losses[-1],
                           mean=mean.tolist(), train_s=secs,
                           ms_per_step=secs * 1e3 / VI_RADIAL_STEPS)

    actnorm = vi_flow([ActNorm(3, **kw)], 3, device)
    bound_target = CorrelatedGaussian(3, 0.5, **kw)
    with torch.no_grad():
        stats["elbo_bound"] = float(elbo(actnorm, bound_target, VI_ELBO_DRAWS,
                                         generator=gen))
        z = actnorm.prior.sample(512, generator=gen)
        e = float(elbo(actnorm, CorrelatedGaussian(3, **kw), z=z))
        r = float(reverse_kl(actnorm, CorrelatedGaussian(3, **kw), z=z))
    stats["elbo_minus_reverse_kl"] = [e, r]
    no_kernel_moved("vi config 2", before)
    log("vi: config 2 " + json.dumps(stats))
    p = stats["planar"]
    if not (p["final_loss"] < p["first_loss"] - 0.2 and cov_err <= 0.25):
        raise AssertionError(f"vi planar: loss {p['first_loss']} -> "
                             f"{p['final_loss']}, covariance off by "
                             f"{cov_err} (JAX's bands: a drop of 0.2, 0.25)")
    if not bool(((mean - 1.0).abs() <= 0.2).all()):
        raise AssertionError(f"vi radial: mean {mean.tolist()} not within "
                             f"0.2 of (1, 1)")
    if not stats["elbo_bound"] < 0.05:
        raise AssertionError(f"vi: ELBO {stats['elbo_bound']} of a "
                             f"normalised target above 0.05")
    if not (math.isfinite(e) and e == -r):
        raise AssertionError(f"vi: elbo {e} != -reverse_kl {-r}")

    # (ii) config 3 at the JAX test's 8-d, with its gates
    cg8 = CorrelatedGaussian(8, 0.6, **kw)
    cov8 = cg8.cov.double().cpu().numpy()

    def gates8(st, x):
        cov = np.cov(x.double().cpu().numpy().T)
        iu = np.triu_indices(8, 1)
        diag = float(np.abs(np.diag(cov) - 1.0).max())
        off = float(np.abs(cov[iu] - cov8[iu]).mean())
        st.update(diag_err=diag, offdiag_err=off)
        if not (diag < 0.3 and off < 0.2):
            raise AssertionError(f"vi correlated8: max |diag - 1| {diag}, "
                                 f"mean |off-diagonal error| {off} (JAX's "
                                 f"bands 0.3, 0.2)")

    stats["correlated8"], _ = vi_spline(
        "correlated8", 4, lambda n: cg8.sample(n, generator=gen), cov8, gen,
        device, gates8)

    # (iii) config 3 at BASELINE's 32-d: JAX's own bands
    def banded(name):
        def gates(st, x):
            off = {k: st[k] for k, b in VI_BANDS[name].items()
                   if not st[k] <= b}
            if off:
                raise AssertionError(f"vi {name}: {off} outside JAX's "
                                     f"bands {VI_BANDS[name]}")
        return gates

    cg32 = CorrelatedGaussian(**kw)   # (32, 0.9): BASELINE's target
    stats["correlated32"], fkl_step = vi_spline(
        "correlated32", 16, lambda n: cg32.sample(n, generator=gen),
        cg32.cov.double().cpu().numpy(), gen, device, banded("correlated32"))
    banana = Banana(32, b=0.1, s0=3.0)
    stats["banana32"], _ = vi_spline(
        "banana32", 16, lambda n: banana.sample(n, generator=gen, **kw),
        banana_cov(32, banana.b, banana.s0), gen, device, banded("banana32"))

    # (v) idle share of an ELBO step and of a forward-KL step (32-d)
    def steps(fn):
        return lambda: [fn() for _ in range(VI_PROFILED)]

    (idle, counts) = launched(lambda: dict(
        elbo_step=device_idle(steps(planar_step)),
        forward_kl_step=device_idle(steps(fkl_step))))
    expect_launches("vi profiled steps", counts, 0, 2 * VI_PROFILED)
    stats["idle"] = idle
    stats["phase_s"] = time.perf_counter() - t_phase
    log("vi: " + json.dumps({k: stats[k] for k in ("idle", "phase_s")}))
    launches = dict(accept_select=0, rqs=counts["rqs"],
                    rqs_vjp=counts["rqs_vjp"])
    for name in ("correlated8", "correlated32", "banana32"):
        for k in launches:
            launches[k] += stats[name]["launches"][k]
    return launches


def kernel_entry(name, source, replaces, by_path, timed, errs, checks):
    """A kernel's record in the kernels line: its launches by path, its
    numbers at the main shape `timed` and at every checked shape."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=max(errs), ms=timed["ms"],
        plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
        bound_by=timed["bound_by"], library_ms=None,
        path_shapes=[dict(shape=list(key), **{
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "max_abs_err")},
            share_of_bound=r["bound_ms"] / r["ms"])
            for key, r in checks.items()])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the bench's depth: 15000 train steps, 1024 draws, "
                    "256 NUTS draws")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from normalizingflow_tpu_torch.ops import _build, hmc, rqs

    log(device_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build([hmc.KERNEL, rqs.KERNEL])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    circular = {}
    for shape in CRQS_SHAPES:
        circular.update(circular_phase(*shape, gen, flush))
    crqs_paths = circular_path(args.seed)
    torch.cuda.empty_cache()
    crqs_main = (*CRQS_SHAPES[0], False)
    circular_kernels = [
        kernel_entry(name, "normalizingflow_tpu_torch/csrc/rqs.cu", None,
                     {p: c[i] for p, c in crqs_paths.items()},
                     circular[crqs_main][i],
                     [r[i]["max_abs_err"] for r in circular.values()],
                     {key: r[i] for key, r in circular.items()})
        for i, name in enumerate(("crqs", "crqs_vjp"))]
    log(f"circular: {time.perf_counter() - t0:.1f} s from the build's start")
    unfused = {shape: check_accept_select(*shape, gen, flush)
               for shape in KERNEL_SHAPES + WIDE_SHAPES}
    fused = {(*shape, mix): check_accept_fused(*shape, mix, gen, flush)
             for shape in KERNEL_SHAPES + WIDE_SHAPES
             for mix in ACCEPT_MIXES}
    rqs_both = {
        (n, k, inverse, bname): check_rqs(n, k, bname, inverse, gen, flush)
        for n in RQS_ROWS for k in RQS_BINS for inverse in (True, False)
        for bname in RQS_BOUNDS}
    rqs_both.update({
        (n, SP_BINS, False, bname): check_rqs(n, SP_BINS, bname, False, gen,
                                              flush)
        for n in FE_RQS_ROWS for bname in RQS_BOUNDS})
    rqs_both.update({key: check_rqs(key[0], key[1], key[3], key[2], gen,
                                    flush) for key in PATH_RQS})
    rqs_results = {key: r[0] for key, r in rqs_both.items()}
    vjp_results = {key: r[1] for key, r in rqs_both.items()}
    del flush
    torch.cuda.empty_cache()

    train_steps, draws = ((FULL_TRAIN_STEPS, FULL_DRAWS) if args.full
                          else (REDUCED_TRAIN_STEPS, REDUCED_DRAWS))
    depth_cut("main", "train steps", train_steps, FULL_TRAIN_STEPS)
    depth_cut("main", "draws", draws, FULL_DRAWS)
    keep_dir = tempfile.TemporaryDirectory()  # trained flows, for later
    keep = Path(keep_dir.name)
    funnel, flow, main_stats = main_path(train_steps, draws, args.seed)
    nuts_draws = FULL_NUTS_DRAWS if args.full else NUTS_DRAWS
    depth_cut("nuts_funnel", "draws", nuts_draws, FULL_NUTS_DRAWS)
    nuts = dict(nuts_funnel=nuts_funnel(flow, nuts_draws, args.seed))
    bench_paths = bench_phase(flow, main_stats, keep, args.seed)
    torch.save(flow.state_dict(), keep / "funnel.pt")
    del flow
    nuts["nuts_eight_schools"] = nuts_eight_schools(args.seed)
    torch.cuda.empty_cache()
    spline = spline_line(args.seed)
    torch.cuda.empty_cache()
    per_point = per_point_phase(keep, spline.pop("flow"),
                                main_stats["step_size"],
                                spline.pop("step_size"), args.seed)
    torch.cuda.empty_cache()
    fe_lj = fe_lj_phase(args.seed)
    torch.cuda.empty_cache()
    fe_einstein = fe_einstein_phase()
    torch.cuda.empty_cache()
    fe_fe400k = fe_fe400k_phase(args.seed)
    torch.cuda.empty_cache()
    fe_phi4, smc, phi4_cfg = fe_phi4_phase(args.seed, keep)
    torch.cuda.empty_cache()
    poly = polymer_phase(args.seed)
    torch.cuda.empty_cache()
    rnvp = polymer_rnvp_phase()
    torch.cuda.empty_cache()
    parallel = parallel_phase(keep, phi4_cfg, args.seed)
    keep_dir.cleanup()
    torch.cuda.empty_cache()
    vi = vi_phase(args.seed)
    jax_resume = jax_resume_phase()
    parity = parity_phase(args.seed)
    fit_studies = fit_studies_phase(args.seed, fe_lj["permutation"])
    log(f"run: {time.perf_counter() - t0:.1f} s from the build's start")

    slice_paths = dict(fe_fe400k=fe_fe400k, fe_phi4=fe_phi4, polymer=poly,
                       polymer_rnvp=rnvp, **nuts, smc_phi4=smc, **parallel,
                       jax_resume=jax_resume, parity=parity,
                       fit_studies=fit_studies, per_point=per_point,
                       vi=vi, **bench_paths)
    accept_paths = {k: v["accept_select"] for k, v in slice_paths.items()}
    path_accept = {(n, d, "main"): fused[(n, d, "main")]
                   for n, d in KERNEL_SHAPES[-4:] + [(SMC_PARTICLES, DIM)]}

    main_shape = (SP_CHAINS * SP_SIZE * (SP_SPACE - 1), SP_BINS, True, "sym")
    kernels = [
        kernel_entry("accept_select",
              "normalizingflow_tpu_torch/csrc/accept_select.cu",
              "normalizingflow_tpu/ops/hmc_pallas.py:56",
              dict(funnel=funnel, spline=spline["accept_select"],
                   fe_lj=fe_lj["accept_select"],
                   fe_einstein=fe_einstein["accept_select"], **accept_paths),
              fused[(CHAINS, DIM, "main")],
              [r["max_abs_err"] for r in (*fused.values(),
                                          *unfused.values())], path_accept),
        kernel_entry("rqs", "normalizingflow_tpu_torch/csrc/rqs.cu",
              "normalizingflow_tpu/ops/rqs_pallas.py:45",
              dict(spline=spline["rqs"], fe_lj=fe_lj["rqs"],
                   fe_einstein=fe_einstein["rqs"],
                   **{k: v["rqs"] for k, v in slice_paths.items()}),
              rqs_results[main_shape],
              [r["max_abs_err"] for r in rqs_results.values()]
              + [p["max_abs_err"] for p in (spline, fe_lj, fe_fe400k,
                                            fe_phi4, poly, parity)],
              {key: rqs_results[key] for key in PATH_RQS}),
        kernel_entry("rqs_vjp", "normalizingflow_tpu_torch/csrc/rqs.cu",
              "normalizingflow_tpu/ops/rqs_pallas.py:264",
              dict(spline=spline["rqs_vjp"], fe_lj=fe_lj["rqs_vjp"],
                   fe_einstein=fe_einstein["rqs_vjp"],
                   **{k: v["rqs_vjp"] for k, v in slice_paths.items()}),
              vjp_results[main_shape],
              [r["max_abs_err"] for r in vjp_results.values()]
              + [p["max_abs_err_vjp"] for p in (spline, fe_lj, fe_fe400k,
                                                fe_phi4, poly, parity)],
              {key: vjp_results[key] for key in PATH_RQS}),
        *circular_kernels,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
