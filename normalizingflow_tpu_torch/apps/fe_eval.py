"""Free-energy evaluation pipeline (the reference's test.py workflow).
Twin of normalizingflow_tpu/apps/fe_eval.py.

  * generate_from_nf / evaluate: flow sampling and density evaluation in
    fixed-size batches (ceiling division, then trim, so any count is
    honoured exactly);
  * fe_diff: the 2x2 work matrix Q from {flow samples, data} x {flow logp,
    -U/kT}, min-shifted for stability, and the four estimates (BAR,
    forward and reverse Zwanzig, MBAR "emus") per particle in kT units;
  * plot_q: the (flow logp, -U/kT) scatter, with matplotlib imported when
    called.

Every draw can be injected (`draws`) so a call can be held against the
JAX package's own numbers; otherwise it comes from `generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..estimators.bar import bar
from ..estimators.mbar import mbar
from ..estimators.zwanzig import zwanzig


def _batches(n, batchsize):
    return range(-(-n // batchsize))


@torch.no_grad()
def generate_from_nf(flow, nsamples, batchsize=500, generator=None, z=None):
    """Flow samples and their model log-densities, (nsamples, dim) and
    (nsamples,): ceil(nsamples / batchsize) batches of `batchsize`, then
    trimmed. `z`: the latents of all batches, at least nsamples rows
    (batch i takes rows i*batchsize...); else drawn from `generator`."""
    xs, lps = [], []
    for i in _batches(nsamples, batchsize):
        zi = None if z is None else z[i * batchsize:(i + 1) * batchsize]
        x, log_px, _ = flow.sample(batchsize, generator=generator, z=zi)
        xs.append(x)
        lps.append(log_px)
    return torch.cat(xs)[:nsamples], torch.cat(lps)[:nsamples]


@torch.no_grad()
def evaluate(flow, x, batchsize=500):
    """Flow log-density of every row of x, in batches of `batchsize`."""
    return torch.cat([flow.log_prob(x[i * batchsize:(i + 1) * batchsize])
                      for i in _batches(len(x), batchsize)])


def _estimates(q0, q1, nsamples, n_particles, kT):
    """The stability shifts, then MBAR, BAR and both Zwanzig estimates on
    the work matrices q0 (flow ensemble) and q1 (data ensemble)."""
    s0 = torch.min(q1[:, 0])
    s1 = torch.min(q1[:, 1])
    shift = torch.stack([s0, s1])
    q0, q1 = q0 - shift, q1 - shift
    # MBAR ("emus"): reduced energies are -log-densities of all pooled
    # samples under both states; log c_k = -f_k
    f = mbar(-torch.cat([q0, q1], dim=0).T, [nsamples, nsamples])
    ds = float(s0 - s1)
    emus = (ds + float(f[1] - f[0])) / n_particles * kT
    w_f = q0[:, 0] - q0[:, 1]
    w_r = -q1[:, 0] + q1[:, 1]
    bar_est = (ds + float(bar(w_f, w_r))) / n_particles * kT
    md = (ds + float(zwanzig(q1[:, 0] - q1[:, 1]))) / n_particles * kT
    nf = (ds + float(-zwanzig(q0[:, 1] - q0[:, 0]))) / n_particles * kT
    return {"bar": bar_est, "md": md, "nf": nf, "emus": emus,
            "Q0": q0.cpu().numpy(), "Q1": q1.cpu().numpy()}


def fe_diff(flow, potential, nsamples, n_particles, kT=1.0, plot_path=None,
            relaxation=False, relaxation_kwargs=None, generator=None,
            draws=None):
    """Free-energy difference between the flow model and the physical
    system: {"bar", "md" (forward Zwanzig), "nf" (reverse Zwanzig), "emus"
    (MBAR)} per particle in kT units, the shifted work matrices "Q0", "Q1",
    and the frames "x0", "x1" that entered them.

    relaxation=True relaxes BOTH ensembles with the same soft-momentum
    kernel (mcmc.relaxation.relaxation_step) before their energies enter
    the work matrix, and the flow log-density of each relaxed frame has
    the relaxation momentum marginalized out.

    `draws` (a dict, every key optional): "z" the flow latents (see
    generate_from_nf), "x1" the data frames, "relax0" and "relax1" each
    ensemble's relaxation draws (see relaxation_step); the rest come from
    `generator`.
    """
    draws = draws or {}
    x0, q00 = generate_from_nf(flow, nsamples, generator=generator,
                               z=draws.get("z"))
    if relaxation:
        from ..mcmc.relaxation import relaxation_step

        def relax(x, key):
            return relaxation_step(flow, potential, x, kT=kT,
                                   generator=generator, draws=draws.get(key),
                                   **(relaxation_kwargs or {}))

        r = relax(x0, "relax0")
        x0, q00, q01 = r.positions, r.q_learned, r.q_energy
    else:
        with torch.no_grad():
            q01 = -potential.potential(x0) / kT
    x1 = draws.get("x1")
    if x1 is None:
        x1 = potential.sample(nsamples, generator=generator)
    x1 = x1.reshape(len(x1), -1).to(x0)
    if relaxation:
        r = relax(x1, "relax1")
        x1, q10, q11 = r.positions, r.q_learned, r.q_energy
    else:
        q10 = evaluate(flow, x1)
        with torch.no_grad():
            q11 = -potential.potential(x1) / kT
    out = _estimates(torch.stack([q00, q01], dim=1),
                     torch.stack([q10, q11], dim=1), nsamples, n_particles,
                     kT)
    out["x0"], out["x1"] = x0.cpu().numpy(), x1.cpu().numpy()
    if plot_path is not None:
        plot_q(out["Q0"], out["Q1"], plot_path)
    return out


def fe_diff_ntrials(flow, potential, nsamples, n_particles, data_paths,
                    kT=1.0, generator=None):
    """Mean and std of the BAR estimate over independent data sets (one
    `fe_diff` each, after `potential.update_data(path)`); returns (mean,
    std, the estimates)."""
    bars = []
    for path in data_paths:
        potential.update_data(path)
        bars.append(fe_diff(flow, potential, nsamples, n_particles, kT,
                            generator=generator)["bar"])
    bars = np.asarray(bars)
    return bars.mean(), bars.std(), bars


def plot_q(q0, q1, path, split=False):
    """Scatter of (flow logp, -U/kT): NF against MD ensembles."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if split:
        fig, (ax1, ax2) = plt.subplots(1, 2, sharex=True, sharey=True,
                                       figsize=(12, 6), tight_layout=True)
        ax1.plot(q0[:, 0], q0[:, 1], ".", color="darkgray")
        ax1.set_title("trajectory generated by NF")
        ax2.plot(q1[:, 0], q1[:, 1], ".", color="darkgray")
        ax2.set_title("trajectory from MD simulation")
        fig.supxlabel("logpx from NF")
        fig.supylabel("-potential (kT)")
        fig.savefig(path)
        plt.close(fig)
    else:
        plt.figure()
        plt.plot(q0[:, 0], q0[:, 1], ".", color="darkblue", label="NF traj")
        plt.plot(q1[:, 0], q1[:, 1], ".", color="darkgray", label="MD traj")
        plt.xlabel("logpx from NF")
        plt.ylabel("-potential (kT)")
        plt.legend()
        plt.savefig(path)
        plt.close()


@torch.no_grad()
def fe_diff_no_training(flow, potential, nsamples, n_particles, kT=1.0,
                        generator=None, draws=None):
    """Prior-only baseline: the work matrix from PRIOR samples (no trained
    flow), solved with MBAR; the per-particle reduced free energies.
    `draws`: {"x0" prior samples, "x1" data frames}, each optional."""
    draws = draws or {}
    x0 = draws.get("x0")
    if x0 is None:
        x0 = flow.prior.sample(nsamples, generator=generator)
    q00 = flow.prior.log_prob(x0)
    q01 = -potential.potential(x0) / kT
    x1 = draws.get("x1")
    if x1 is None:
        x1 = potential.sample(nsamples, generator=generator)
    x1 = x1.reshape(len(x1), -1).to(x0)
    q10 = flow.prior.log_prob(x1)
    q11 = -potential.potential(x1) / kT
    u = -torch.cat([torch.stack([q00, q01], dim=1),
                    torch.stack([q10, q11], dim=1)], dim=0).T
    f = mbar(u, [nsamples, nsamples])
    return (f * kT / n_particles).cpu().numpy()
