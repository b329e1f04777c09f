"""HMC on a particle system's potential, no flow: the training data of the
reference's free-energy workflow, as `apps.sample_data.generate` makes it
(warmup-adapted chains started from the prior, L leapfrog steps, every
`thin`-th state kept), through the program's `mcmc.run_hmc` on the
configuration's `LennardJones.log_prob`, `draws_per_call` kept draws a
call.

Set-up: the program's adaptation (`run_hmc` with warmup) on
`adapt_chains` prior draws, which gives the step size and mass, and
`burn_in_calls` untimed calls at the cell's chain count, which warm up
the shapes and burn the window's chains in. The adaptation draws from the
traffic's `adapt_seed`, not from `--seed`: the step size and mass are the
sampler's settings, and adapted from each run's seed they moved the ESS a
draw with the seed (as a fit from the seed moved the NeuTra cell's); the
seed draws the window's chains, momenta and accept uniforms. The window's
chains start from fresh prior draws (the lattice plus Gaussian noise of
variance 1/alpha, wrapped), which the burn-in carries to the target's
spread (the mean energy settles within ~8 transitions), kept unwrapped
as the chains move them. The window's transitions
take their raw draws from the benchmark (`run_hmc(draws=...)`), transition
t's from its own seed, so that the check can draw them again.

`ess_per_s`: the min over coordinates of the bulk ESS of x and of x^2 over
every kept draw of the window, over the window's seconds, x a frame's
displacements from the lattice sites, each by minimum image, less their
mean. In raw positions the ESS reads about one a chain, whatever the
window's length: a site on the box's face splits the chains' draws
between its two images L apart, which no chain crosses, and the energy
does not move under a translation of every particle, so the centre of
mass walks freely. A unit of work is a transition (`thin` a kept
draw).

The check follows the program from its own states, as the NeuTra cell's
(kinds/neutra_hmc.py): at sampled kept draws (the first, the last and
others from the seed) and sampled chains, the program replays the draw's
first `thin` - 1 transitions from the previous kept draw (the states in
between are not kept), and the float64 reference runs each of the
`thin` transitions from the program's state before it with the same raw
draws. Numbers: `hmc_pos_gap`, `hmc_flip_margin`, `lp_gap` (the
program's log-density at its position). A traced run replays the traced
calls' in-between states too, for the accept kernel's counts.
"""

from __future__ import annotations

import torch

from nfbench import ljref, refcore, yardstick
from nfbench.kinds import (
    Outcome,
    Window,
    generator,
    memory_peak,
    sub_seed,
    sync,
)
from nfbench.kinds.neutra_hmc import Draws, check_chains
from nfbench.trace import span


def target_config(cell):
    """(N, box side, cutoff, kT) of the configuration."""
    cfg = cell.cfg
    return (cfg["nparticles"], 2.0 * cell.ref.half_box(cfg), cfg["cutoff"],
            cfg["kT"])


class Port:
    """The program: the configuration's LJ target (`config.build_potential`
    as sample_data builds it) and `run_hmc`."""

    def __init__(self, cell):
        from normalizingflow_tpu_torch.config import (
            DatasetConfig,
            build_potential,
        )
        from normalizingflow_tpu_torch.mcmc import run_hmc

        n, length, cutoff, kt = target_config(cell)
        ds = DatasetConfig(potential="LJ", nparticles=n,
                           dim=cell.cfg["dim"], kT=kt, cutoff=cutoff,
                           rho=cell.cfg["rho"])
        self.target = build_potential("LJ", ds, ds, boxlength=length,
                                      device=cell.device,
                                      dtype=torch.float32)
        self.logprob = self.target.log_prob
        self.run_hmc, self.device = run_hmc, cell.device
        self.thin = cell.traffic["thin"]
        self.session = torch.no_grad

    def adapt(self, z0, gen, warmup, step0, leapfrog):
        res = self.run_hmc(gen, self.logprob, z0, 1, num_warmup=warmup,
                           step_size=step0, num_leapfrog=leapfrog,
                           thin=self.thin, device=self.device)
        return float(res.step_size), res.inv_mass_diag

    def chunk(self, z, n, draws, step, inv_mass, leapfrog, thin=None):
        res = self.run_hmc(None, self.logprob, z, n, num_warmup=0,
                           step_size=step, inv_mass_diag=inv_mass,
                           num_leapfrog=leapfrog, thin=thin or self.thin,
                           draws=draws, device=self.device)
        return res.samples, res.log_probs, res.final_state.position


class Reference:
    """The reference in the program's place (the control): the same
    transitions in `prec`, at the step size and mass of the program's own
    adaptation (sampler settings, not results: at the traffic's initial
    step size the LJ solid rejects every proposal)."""

    def __init__(self, cell, prec="tf32"):
        n, length, cutoff, kt = target_config(cell)
        self.lp_grad = refcore.lp_and_grad(
            lambda x: ljref.log_prob(x, n, length, cutoff, kt, prec))
        self.dtype = refcore.DTYPES[prec]
        self.thin = cell.traffic["thin"]
        self.session = torch.no_grad
        self.adapt = Port(cell).adapt

    def chunk(self, z, n, draws, step, inv_mass, leapfrog, thin=None):
        thin = thin or self.thin
        z = z.to(self.dtype)
        lp, _ = self.lp_grad(z)
        zs, lps = [], []
        for _ in range(n * thin):
            d = [t.to(self.dtype) for t in next(draws)]
            q, lp_q, _, _, _, acc = refcore.hmc_transition(
                self.lp_grad, z, d, step, inv_mass.to(self.dtype), leapfrog)
            z = torch.where(acc[:, None], q, z)
            lp = torch.where(acc, lp_q, lp)
            zs.append(z.float())
            lps.append(lp.float())
        return (torch.stack(zs[thin - 1::thin]),
                torch.stack(lps[thin - 1::thin]), z.float())


def prior_draws(cell, n, gen):
    """n prior draws: the lattice plus N(0, 1/alpha), wrapped, flattened."""
    cfg = cell.cfg
    centers = cell.ref.lattice(cfg, cell.device)
    length = 2.0 * cell.ref.half_box(cfg)
    z = centers + torch.randn(n, *centers.shape, generator=gen,
                              device=cell.device) / cfg["prior_alpha"] ** 0.5
    return ljref.minimum_image(z, length).reshape(n, -1)


def run(cell, system=None):
    tr, dev, seed = cell.traffic, cell.device, cell.seed
    chains, lf, thin = tr["chains"], tr["leapfrog"], tr["thin"]
    k = tr["draws_per_call"]
    per_call = k * thin
    dim = cell.cfg["nparticles"] * cell.cfg["dim"]
    cell.mark("weights")
    system = (system or Port)(cell)
    cell.mark("build")
    draws = Draws(seed, chains, dim, dev)
    window = Window(cell)
    cs = check_chains(seed, chains, tr).to(dev)
    # kept through the window: every kept draw; the log-densities of the
    # checked chains; the traced calls' start positions and kept draws
    xs, lpcs, traced = [], [], []
    with system.session():
        z0 = prior_draws(cell, tr["adapt_chains"],
                         generator(dev, tr["adapt_seed"], "adapt_chains"))
        step, inv_mass = system.adapt(
            z0, generator(dev, tr["adapt_seed"], "adapt"), tr["warmup"],
            tr["init_step_size"], lf)
        z = prior_draws(cell, chains, generator(dev, seed, "chains"))
        sync(dev)
        cell.mark("adapt")
        # burn-in, which warms up the shapes, on draws the window does not
        # use: the prior's variance is ~2.6x under the target's
        warm = Draws(sub_seed(seed, "warm"), chains, dim, dev)
        for c in range(tr["burn_in_calls"]):
            z = system.chunk(z, k, warm.run(c * per_call, per_call), step,
                             inv_mass, lf)[2]
        sync(dev)
        z_start = z
        window.open()
        while True:
            tracing = cell.tracer.active
            with span("run_hmc"):
                zc, lpc, z_next = system.chunk(
                    z, k, draws.run(window.units, per_call), step, inv_mass,
                    lf)
            xs.append(zc)
            lpcs.append(lpc[:, cs])
            if tracing:
                traced.append((window.units, z, zc))
            z = z_next
            del zc, lpc
            if window.done(per_call):
                break
        seconds = window.close()
    del z, z_next
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=0,
                  trace=cell.tracer.summary)
    if out.trace is None:
        sites = cell.ref.lattice(cell.cfg, dev)
        out.e2e["ess_per_s"] = yardstick.min_bulk_ess(
            [displacements(cell, sites, zc) for zc in xs],
            dim_chunk=1) / seconds
    out.memory_peak = memory_peak(dev)
    kept = window.units // thin

    def at(parts, i):
        return parts[i // k][i % k]

    picks = {"chains": cs, "draws": check_draws(seed, kept, tr)}
    before = {i: (z_start if i == 0 else at(xs, i - 1)) for i in
              picks["draws"]}
    states = {i: (at(xs, i)[cs], at(lpcs, i)) for i in picks["draws"]}
    if out.trace is not None:
        out.layer["accepted"] = accept_counts(
            system, traced, draws, step, inv_mass, lf, thin)[
            :out.trace.units]
        out.layer["chains"], out.layer["dim"] = chains, dim
    del traced, xs, lpcs
    path = {}
    with system.session():
        for i in picks["draws"]:
            mids = system.chunk(before[i], thin - 1, draws.run(
                i * thin, thin - 1), step, inv_mass, lf, thin=1)[0][
                :, cs] if thin > 1 else []
            path[i] = [before[i][cs], *mids, states[i][0]]
    del before
    out.checks = check(cell, path, states, draws, picks, step, inv_mass)
    return out


def displacements(cell, sites, zc):
    """Kept draws (k, chains, N * 3) as each particle's displacement from
    its lattice site by minimum image, less the frame's mean
    displacement."""
    u = ljref.minimum_image(zc.reshape(*zc.shape[:2], *sites.shape) - sites,
                            2.0 * cell.ref.half_box(cell.cfg))
    return (u - u.mean(dim=2, keepdim=True)).reshape(zc.shape)


def accept_counts(system, traced, draws, step, inv_mass, lf, thin):
    """Accepted chains of each transition of the calls `traced`, a list of
    (first transition, position before the call, its kept draws): the
    states between kept draws are replayed by the program from the kept
    draw before them with the same raw draws."""
    counts = []
    with system.session():
        for t0, before, zc in traced:
            prev = before
            for j, zt in enumerate(zc):
                mids = system.chunk(prev, thin - 1, draws.run(
                    t0 + j * thin, thin - 1), step, inv_mass, lf,
                    thin=1)[0] if thin > 1 else []
                for m in list(mids) + [zt]:
                    counts.append(int((m != prev).any(dim=1).sum()))
                    prev = m
    return counts


def check_draws(seed, kept, tr):
    """The kept draws the check compares: the first, the last, others
    from the seed."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "check"))
    n_t = min(tr["check_transitions"], kept)
    inner = torch.randperm(max(kept - 2, 0), generator=gen)[
        :max(n_t - 2, 0)] + 1
    return sorted({0, kept - 1, *inner.tolist()})


def check(cell, path, states, draws, picks, step, inv_mass):
    """The float64 reference against each of the program's transitions on
    `path` (its states before, between and at the picked kept draws), from
    the program's state before each, with the same draws."""
    n, length, cutoff, kt = target_config(cell)
    tr, thin = cell.traffic, cell.traffic["thin"]

    def lp_fn(x):
        return ljref.log_prob(x, n, length, cutoff, kt, "float64")

    lp_grad = refcore.lp_and_grad(lp_fn)
    cs = picks["chains"].to(cell.device)
    m = inv_mass.double()
    gaps = {"hmc_pos_gap": [0.0], "hmc_flip_margin": [0.0], "lp_gap": [0.0]}
    for i in picks["draws"]:
        for j in range(thin):
            z_prev, z_now = path[i][j].double(), path[i][j + 1].double()
            d = [v[cs].double() for v in draws.at(i * thin + j)]
            q, _, _, log_a, log_u, acc_ref = refcore.hmc_transition(
                lp_grad, z_prev, d, step, m, tr["leapfrog"])
            acc = (z_now != z_prev).any(dim=1)
            both = acc & acc_ref
            rel = (z_now - q).abs() / (1 + q.abs().amax(dim=1, keepdim=True))
            gaps["hmc_pos_gap"].append(refcore.worst(rel[both]))
            gaps["hmc_flip_margin"].append(refcore.worst(
                (log_u - log_a).abs()[acc != acc_ref]))
        z_now, lp_now = states[i][0].double(), states[i][1].double()
        with torch.no_grad():
            lp_ref = lp_fn(z_now)
        gaps["lp_gap"].append(refcore.worst(
            (lp_now - lp_ref).abs() / (1 + lp_ref.abs())))
    return [(k, refcore.worst_of(v)) for k, v in gaps.items()]
