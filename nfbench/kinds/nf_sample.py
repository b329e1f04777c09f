"""Flow frames and their log-densities through the program's
`apps.fe_eval.generate_from_nf`, one batch of `batch` latents a call, the
latents made by the benchmark from the prior (the lattice plus Gaussian
noise of variance 1/alpha, wrapped), batch i's from its own seed.

`nf_frames_per_s`: the frames completed in the window over its seconds.

The check: at sampled rows of sampled batches (the first, the last, others
from the seed), the float64 reference samples the same latents. Numbers:
`x_gap` (the frames, over 1 + |x|) and `logp_gap` (their log-densities,
over 1 + |log p|).
"""

from __future__ import annotations

import math

import torch

from nfbench import refcore
from nfbench.kinds import (
    Outcome,
    Window,
    generator,
    memory_peak,
    sub_seed,
)
from nfbench.trace import span


class Port:
    """The program: its NSF_AR flow holding the benchmark's weights, and
    generate_from_nf."""

    def __init__(self, cell, params, centers):
        from normalizingflow_tpu_torch.apps.fe_eval import generate_from_nf
        from nfbench.ports import nsf_ar

        self.flow = nsf_ar.build(cell.cfg, params, centers,
                                 cell.ref.half_box(cell.cfg), cell.device)
        self.generate = generate_from_nf

    def sample(self, z):
        return self.generate(self.flow, z.shape[0], batchsize=z.shape[0],
                             z=z)


class Reference:
    """The reference in the program's place (the control), in `prec`."""

    def __init__(self, cell, params, centers, prec="tf32"):
        self.cell, self.prec = cell, prec
        self.p = cell.ref.cast(params, prec)
        self.centers = centers.to(refcore.DTYPES[prec])

    @torch.no_grad()
    def sample(self, z):
        x, lp = self.cell.ref.sample(self.cell.cfg, self.p, self.centers,
                                     z.to(refcore.DTYPES[self.prec]),
                                     self.prec)
        return x.float(), lp.float()


class Latents:
    """Batch i's latents: prior draws from a generator seeded for i
    alone."""

    def __init__(self, cell, centers):
        cfg = cell.cfg
        self.seed, self.batch = cell.seed, cell.traffic["batch"]
        self.centers = centers
        self.sd = 1.0 / math.sqrt(cfg["prior_alpha"])
        self.length = 2.0 * cell.ref.half_box(cfg)
        self.gen = torch.Generator(device=cell.device)
        self.device = cell.device

    def at(self, i):
        self.gen.manual_seed(sub_seed(self.seed, "latents", i))
        z = self.centers + self.sd * torch.randn(
            self.batch, *self.centers.shape, generator=self.gen,
            device=self.device)
        z = z - (torch.abs(z) > 0.5 * self.length) * torch.sign(z) * \
            self.length
        return z.reshape(self.batch, -1)


def run(cell, system=None):
    cfg, tr, ref, dev, seed = (cell.cfg, cell.traffic, cell.ref, cell.device,
                               cell.seed)
    params = ref.init_params(cfg, generator(dev, seed, "init"), dev)
    cell.mark("weights")
    centers = ref.lattice(cfg, dev)
    system = (system or Port)(cell, params, centers)
    cell.mark("build")
    latents = Latents(cell, centers)
    system.sample(latents.at(-1))  # warm, on latents the window does not use
    window = Window(cell)
    outs = []
    window.open()
    while True:
        z = latents.at(window.units)
        with span("generate_from_nf"):
            outs.append(system.sample(z))
        if window.done(1):
            break
    seconds = window.close()
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=memory_peak(dev),
                  trace=cell.tracer.summary)
    out.e2e["nf_frames_per_s"] = window.units * tr["batch"] / seconds
    out.layer["flops_per_unit"] = ref.flops_sample(cfg, tr["batch"])
    out.layer["rows_per_unit"] = tr["batch"]
    if out.trace is not None:
        out.layer["rqs_calls"] = rqs_calls(cell, params, centers,
                                           latents.at(0))
    picks = check_picks(seed, window.units, tr)
    rows = picks["rows"].to(dev)
    got = {i: (outs[i][0][rows], outs[i][1][rows]) for i in picks["batches"]}
    del outs, system
    out.checks = check(cell, params, centers, latents, picks, got)
    return out


def rqs_calls(cell, params, centers, z):
    """The RQS calls of one batch's sampling, on its first `bound_rows`
    rows, as the float32 reference makes them: the inputs of the byte
    count, scaled to the batch by the reader."""
    log = []
    rows = cell.traffic["bound_rows"]
    with torch.no_grad():
        cell.ref.sample(cell.cfg, params, centers, z[:rows], "float32", log)
    return log


def check_picks(seed, batches, tr):
    gen = torch.Generator().manual_seed(sub_seed(seed, "check"))
    n_b = min(tr["check_batches"], batches)
    inner = torch.randperm(max(batches - 2, 0), generator=gen)[
        :max(n_b - 2, 0)] + 1
    return {"batches": sorted({0, batches - 1, *inner.tolist()}),
            "rows": torch.randperm(tr["batch"], generator=gen)[
                :tr["check_rows"]]}


def check(cell, params, centers, latents, picks, got):
    """The float64 reference's frames and log-densities against the
    program's."""
    p = cell.ref.cast(params, "float64")
    c64 = centers.double()
    rows = picks["rows"].to(cell.device)
    x_gap, lp_gap = [0.0], [0.0]
    for i in picks["batches"]:
        z = latents.at(i)[rows].double()
        with torch.no_grad():
            x_ref, lp_ref = cell.ref.sample(cell.cfg, p, c64, z, "float64")
        x, lp = (v.double() for v in got[i])
        x_gap.append(refcore.worst((x - x_ref).abs() / (1 + x_ref.abs())))
        lp_gap.append(refcore.worst((lp - lp_ref).abs()
                                    / (1 + lp_ref.abs())))
    return [("x_gap", refcore.worst_of(x_gap)),
            ("logp_gap", refcore.worst_of(lp_gap))]
