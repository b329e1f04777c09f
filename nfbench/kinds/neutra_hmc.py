"""NeuTra-HMC: HMC on the flow's pullback density through the program's
`mcmc.run_hmc`, `chunk` transitions a call, every draw pushed to data space
by `mcmc.push_to_data` inside the window and kept on the device for the
ESS. Of the latent draws, only the checked chains' are kept, and the
traced chunks' for the accept counts.

Set-up: the benchmark's own reverse-KL fit of the flow (the reference's
plain torch, from the configuration's fit_seed), the program's adaptation
(`run_hmc` with warmup) on `adapt_chains` prior draws, which gives the step
size and mass, and one untimed chunk at the cell's chain count. The window
starts from fresh prior draws: the flow makes the pullback close to the
prior, so they start near equilibrium. The window's
transitions take their raw draws from the benchmark (`run_hmc(draws=...)`),
transition t's from its own seed, so the check can draw them again.

`ess_per_s`: the min over coordinates of the bulk ESS of x and of x^2 over
every draw of the window, over the window's seconds.

The check follows the program from its own states: at sampled transitions
(the first, the last and others drawn from the seed) and sampled chains,
the float64 reference takes the program's previous position and the same
draws, runs the transition, and compares. Numbers: `hmc_pos_gap` (the
accepted position against the reference's proposal), `hmc_flip_margin`
(the largest |log u - log acceptance| where the two accept decisions
differ; decisions that close may differ by rounding), `lp_gap` (the
program's log-density at its position), `push_gap` (the pushed draw).
"""

from __future__ import annotations

import torch

from nfbench import refcore, yardstick
from nfbench.kinds import (
    Outcome,
    Window,
    generator,
    memory_peak,
    sub_seed,
    sync,
)
from nfbench.trace import span


class Port:
    """The program: its flow holding the benchmark's weights, `run_hmc`
    and `push_to_data`."""

    def __init__(self, cell, params):
        from normalizingflow_tpu_torch.mcmc import (
            pullback_logprob_batched,
            push_to_data,
            run_hmc,
        )
        from normalizingflow_tpu_torch.mcmc.neutra import frozen
        from nfbench.ports import realnvp

        device = cell.device
        self.flow, target = realnvp.build(cell.cfg, params, device)
        self.logprob = pullback_logprob_batched(self.flow, target)
        self.run_hmc, self.push_to_data = run_hmc, push_to_data
        self.session = lambda: frozen(self.flow)
        self.device = device

    def adapt(self, z0, gen, warmup, step0, leapfrog):
        res = self.run_hmc(gen, self.logprob, z0, 1, num_warmup=warmup,
                           step_size=step0, num_leapfrog=leapfrog,
                           device=self.device)
        return res.final_state.position, float(res.step_size), \
            res.inv_mass_diag

    def chunk(self, z, n, draws, step, inv_mass, leapfrog):
        res = self.run_hmc(None, self.logprob, z, n, num_warmup=0,
                           step_size=step, inv_mass_diag=inv_mass,
                           num_leapfrog=leapfrog, draws=draws,
                           device=self.device)
        return res.samples, res.log_probs, res.final_state.position

    def push(self, zs):
        return self.push_to_data(self.flow, zs)


class Reference:
    """The reference in the program's place (the control): the same
    transitions and push in `prec`, no adaptation (the traffic's initial
    step size, unit mass)."""

    def __init__(self, cell, params, prec="tf32"):
        cfg, ref = cell.cfg, cell.ref
        self.cfg, self.ref, self.prec = cfg, ref, prec
        self.p = ref.cast(params, prec)
        self.lp_grad = refcore.lp_and_grad(ref.pullback_lp(cfg, self.p,
                                                           prec))
        self.dtype = refcore.DTYPES[prec]
        self.session = torch.no_grad

    def adapt(self, z0, gen, warmup, step0, leapfrog):
        return z0, step0, torch.ones(z0.shape[1], device=z0.device)

    def chunk(self, z, n, draws, step, inv_mass, leapfrog):
        z = z.to(self.dtype)
        lp, _ = self.lp_grad(z)
        zs, lps = [], []
        for _ in range(n):
            d = [t.to(self.dtype) for t in next(draws)]
            q, lp_q, _, _, _, acc = refcore.hmc_transition(
                self.lp_grad, z, d, step, inv_mass.to(self.dtype), leapfrog)
            z = torch.where(acc[:, None], q, z)
            lp = torch.where(acc, lp_q, lp)
            zs.append(z.float())
            lps.append(lp.float())
        return torch.stack(zs), torch.stack(lps), z.float()

    def push(self, zs):
        flat = zs.reshape(-1, zs.shape[-1]).to(self.dtype)
        x = torch.cat([self.ref.inverse(self.cfg, self.p, part, self.prec)[0]
                       for part in flat.split(65536)])
        return x.float().reshape(zs.shape)


class Draws:
    """Transition t's raw draws (jitter, momentum, accept uniforms), from a
    generator seeded for t alone."""

    def __init__(self, seed, chains, dim, device):
        self.seed, self.chains, self.dim = seed, chains, dim
        self.gen = torch.Generator(device=device)
        self.device = device

    def at(self, t):
        self.gen.manual_seed(sub_seed(self.seed, "draws", t))
        kw = dict(generator=self.gen, device=self.device)
        jitter = torch.rand(self.chains, 1, **kw) * 2.0 - 1.0
        normal = torch.randn(self.chains, self.dim, **kw)
        accept = torch.rand(self.chains, **kw)
        return jitter, normal, accept

    def run(self, start, n):
        return (self.at(t) for t in range(start, start + n))


def run(cell, system=None):
    cfg, tr, ref, dev, seed = (cell.cfg, cell.traffic, cell.ref, cell.device,
                               cell.seed)
    chains, dim, k, lf = tr["chains"], cfg["dim"], tr["chunk"], tr["leapfrog"]
    # the flow is the configuration's: fitted from its own fit_seed, so
    # that every seed samples the same model and draws only the chains
    params = ref.init_params(cfg, generator(dev, cfg["fit_seed"], "init"),
                             dev)
    cell.mark("weights")
    params = ref.fit(cfg, params, generator(dev, cfg["fit_seed"], "fit"))
    sync(dev)
    cell.mark("fit")
    system = (system or Port)(cell, params)
    cell.mark("build")
    draws = Draws(seed, chains, dim, dev)
    window = Window(cell)
    cs = check_chains(seed, chains, tr).to(dev)
    # kept through the window: every pushed draw; the latent draws and
    # log-densities of the checked chains alone; the traced chunks' whole
    # positions (with the position before each), for the accept counts
    xs, zcs, lpcs, traced = [], [], [], []
    with system.session():
        z0 = torch.randn(tr["adapt_chains"], dim, device=dev,
                         generator=generator(dev, seed, "adapt_chains"))
        _, step, inv_mass = system.adapt(
            z0, generator(dev, seed, "adapt"), tr["warmup"],
            tr["init_step_size"], lf)
        z = torch.randn(chains, dim, generator=generator(dev, seed, "chains"),
                        device=dev)
        cell.mark("adapt")
        # warm: one chunk and its push, on draws the window does not use
        warm = Draws(sub_seed(seed, "warm"), chains, dim, dev)
        system.push(system.chunk(z, k, warm.run(0, k), step, inv_mass, lf)[0])
        z_start = z[cs]
        window.open()
        while True:
            tracing = cell.tracer.active
            with span("run_hmc"):
                zc, lpc, z_next = system.chunk(
                    z, k, draws.run(window.units, k), step, inv_mass, lf)
            with span("push_to_data"):
                xs.append(system.push(zc))
            zcs.append(zc[:, cs])
            lpcs.append(lpc[:, cs])
            if tracing:
                traced.append((z, zc))
            z = z_next
            del zc, lpc
            if window.done(k):
                break
        seconds = window.close()
    del z, z_next
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=0,
                  trace=cell.tracer.summary)
    if out.trace is None:
        out.e2e["ess_per_s"] = yardstick.min_bulk_ess(xs, dim_chunk=1) \
            / seconds
    # read after the ESS, so that the peak holds its temporaries too
    out.memory_peak = memory_peak(dev)
    if out.trace is not None:
        out.layer["accepted"] = accept_counts(traced)[:out.trace.units]
        out.layer["chains"], out.layer["dim"] = chains, dim
    del traced
    out.layer["flops_per_unit"] = chains * (
        lf * ref.flops_grad_eval(cfg, 1) + ref.flops_inverse(cfg, 1))

    def at(parts, t):
        return parts[t // k][t % k]

    picks = {"chains": cs,
             "transitions": check_transitions(seed, window.units, tr)}
    sample = {t: z_start if t == 0 else at(zcs, t - 1)
              for t in picks["transitions"]}
    now = {t: (at(zcs, t), at(lpcs, t), at(xs, t)[cs])
           for t in picks["transitions"]}
    del zcs, lpcs, xs
    out.checks = check(cell, params, sample, now, draws, picks, step,
                       inv_mass)
    return out


def accept_counts(traced):
    """Accepted chains of each transition of the chunks `traced`, a list
    of (position before the chunk, the chunk's positions)."""
    counts = []
    for before, zc in traced:
        prev = before
        for zt in zc:
            counts.append(int((zt != prev).any(dim=1).sum()))
            prev = zt
    return counts


def check_chains(seed, chains, tr):
    """The chains the check compares, from the seed alone."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "check", "chains"))
    return torch.randperm(chains, generator=gen)[:tr["check_chains"]]


def check_transitions(seed, transitions, tr):
    """The transitions the check compares: the first, the last, others
    from the seed."""
    gen = torch.Generator().manual_seed(sub_seed(seed, "check"))
    n_t = min(tr["check_transitions"], transitions)
    inner = torch.randperm(max(transitions - 2, 0), generator=gen)[
        :max(n_t - 2, 0)] + 1
    return sorted({0, transitions - 1, *inner.tolist()})


def check(cell, params, sample, now, draws, picks, step, inv_mass):
    """The float64 reference against the program's transitions, from the
    program's previous positions and the same draws."""
    cfg, ref, tr = cell.cfg, cell.ref, cell.traffic
    p = ref.cast(params, "float64")
    lp_fn = ref.pullback_lp(cfg, p, "float64")
    lp_grad = refcore.lp_and_grad(lp_fn)
    cs = picks["chains"].to(cell.device)
    m = inv_mass.double()
    gaps = {"hmc_pos_gap": [0.0], "hmc_flip_margin": [0.0], "lp_gap": [0.0],
            "push_gap": [0.0]}
    for t in picks["transitions"]:
        z_prev = sample[t].double()
        z_now, lp_now, x_now = (v.double() for v in now[t])
        d = [v[cs].double() for v in draws.at(t)]
        q, _, _, log_a, log_u, acc_ref = refcore.hmc_transition(
            lp_grad, z_prev, d, step, m, tr["leapfrog"])
        acc = (z_now != z_prev).any(dim=1)
        both = acc & acc_ref
        rel = (z_now - q).abs() / (1 + q.abs().amax(dim=1, keepdim=True))
        gaps["hmc_pos_gap"].append(refcore.worst(rel[both]))
        gaps["hmc_flip_margin"].append(refcore.worst(
            (log_u - log_a).abs()[acc != acc_ref]))
        with torch.no_grad():
            lp_ref = lp_fn(z_now)
            x_ref, _ = ref.inverse(cfg, p, z_now, "float64")
        gaps["lp_gap"].append(refcore.worst(
            (lp_now - lp_ref).abs() / (1 + lp_ref.abs())))
        gaps["push_gap"].append(refcore.worst(
            (x_now - x_ref).abs() / (1 + x_ref.abs())))
    return [(k, refcore.worst_of(v)) for k, v in gaps.items()]
