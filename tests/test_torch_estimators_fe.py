"""Parity of the port's free-energy estimators and of `fe_diff` with the
JAX package, in float64.

BAR, Zwanzig, MBAR and `mbar_from_q` take the same work values and agree
at rtol 1e-10. `fe_diff`, with and without relaxation, runs a small LJ
system (4 particles, 2 x SplineAR) whose weights `params.from_jax` brings
over, with JAX's own draws injected (the flow's latents, the data rows and
both ensembles' relaxation momenta): Q0, Q1 and the four estimates agree
at rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.apps import fe_eval as jfe
from normalizingflow_tpu.estimators.bar import bar as j_bar
from normalizingflow_tpu.estimators.bar import bar_zero as j_bar_zero
from normalizingflow_tpu.estimators.mbar import mbar as j_mbar
from normalizingflow_tpu.estimators.mbar import mbar_from_q as j_mbar_from_q
from normalizingflow_tpu.estimators.zwanzig import zwanzig as j_zwanzig
from normalizingflow_tpu.estimators.zwanzig import (
    zwanzig_forward as j_zwanzig_forward,
)
from normalizingflow_tpu.targets.lj import LennardJones as JLJ

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.apps import fe_eval
from normalizingflow_tpu_torch.estimators import (
    bar,
    bar_zero,
    mbar,
    mbar_from_q,
    zwanzig,
    zwanzig_forward,
)
from normalizingflow_tpu_torch.targets import LennardJones

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
NP_, KT, ALPHA, BINS, HIDDEN = 4, 2.0, 100.0, 4, 8
HALF = (NP_ / (8 * 1.28)) ** (1 / 3)
BOX = 2 * HALF
# a one-cell fcc solid, its lattice rounded to float32 as the JAX
# EinsteinCrystal stores it
CENTERS = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
           * BOX - BOX / 4).astype(np.float32).astype(np.float64)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol, atol=0.0, msg=""):
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().numpy()
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ------------------------------------------------------------ estimators
@pytest.mark.parametrize("shift", [0.0, 4.0])
def test_bar_and_zwanzig_match_jax(shift):
    rng = np.random.default_rng(int(shift))
    w_f = rng.normal(shift, 1.5, 300)
    w_r = rng.normal(-shift, 1.5, 200)
    close(bar(t(w_f), t(w_r)), j_bar(w_f, w_r), rtol=1e-10)
    close(bar(w_f, w_r, delta_f_init=1.0, relative_tolerance=1e-9),
          j_bar(w_f, w_r, delta_f_init=1.0, relative_tolerance=1e-9),
          rtol=1e-10)
    for d in (-1.0, 0.0, 2.5):
        close(bar_zero(t(w_f), t(w_r), torch.tensor(d, dtype=torch.float64)),
              j_bar_zero(jnp.asarray(w_f), jnp.asarray(w_r), d),
              rtol=1e-10, atol=1e-13)
    close(zwanzig(t(w_f)), j_zwanzig(jnp.asarray(w_f)), rtol=1e-10)
    close(zwanzig_forward(t(w_f), t(w_f[::-1])),
          j_zwanzig_forward(w_f, w_f[::-1]), rtol=1e-10, atol=1e-13)
    assert bar(w_f, w_r).dtype == torch.float64


def test_bar_stops_after_two_iterations_at_the_fixed_point():
    """JAX's cond: at least 2 iterations, however small the change."""
    w = np.zeros(10)
    assert float(bar(w, w)) == float(j_bar(w, w)) == 0.0


@pytest.mark.parametrize("k_states", [2, 3])
def test_mbar_matches_jax(k_states):
    rng = np.random.default_rng(k_states)
    n_k = [200, 150, 150][:k_states]
    u = rng.normal(0, 1, (k_states, sum(n_k))) + np.arange(k_states)[:, None]
    close(mbar(t(u), n_k), j_mbar(u, np.array(n_k)), rtol=1e-10,
          atol=1e-13)
    q = rng.normal(0, 1, (2, 120, 2))
    f, log_c = mbar_from_q(t(q))
    jf, jlog_c = j_mbar_from_q(q)
    close(f, jf, rtol=1e-10, atol=1e-13)
    close(log_c, jlog_c, rtol=1e-10, atol=1e-13)
    assert float(f[0]) == 0.0


def test_two_state_mbar_equals_bar():
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (2, 300, 2))
    f, _ = mbar_from_q(t(q))
    w_f = q[0][:, 0] - q[0][:, 1]
    w_r = -q[1][:, 0] + q[1][:, 1]
    # MBAR stops at a change of 1e-8, its tolerance
    close(f[1] - f[0], bar(w_f, w_r, relative_tolerance=1e-12), rtol=0,
          atol=1e-8)


# ------------------------------------------------------------- fe_diff
def lj_system(seed=0, frames=40):
    """The JAX and port flows (prior EinsteinCrystal on the lattice, 2 x
    SplineAR periodic) with shared perturbed weights, and the LJ target
    in each package with the same data frames attached."""
    kw = dict(num_bins=BINS, tail_bound=HALF, hidden_dim=HIDDEN)
    jflow = JFlow(jd.EinsteinCrystal(CENTERS, ALPHA, boxlength=BOX),
                  jb.Chain([jb.SplineAR(3 * NP_, **kw) for _ in range(2)]))
    tflow = nft.NormalizingFlow(
        td.EinsteinCrystal(CENTERS, ALPHA, boxlength=BOX, **F64),
        tb.Chain([tb.SplineAR(3 * NP_, **kw, **F64) for _ in range(2)]))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    data = CENTERS.reshape(1, -1) + 0.04 * rng.standard_normal(
        (frames, 3 * NP_))
    jpot = JLJ(NP_, BOX, cutoff=1.6, kT=KT)
    jpot.update_data(data=data)
    tpot = LennardJones(NP_, BOX, cutoff=1.6, kT=KT, **F64)
    tpot.update_data(data=data)
    return jflow, p, jpot, tflow, tpot


def jax_relax_draws(key, n, dim, npoints=10):
    k_mom, k_v = jax.random.split(key)
    return (t(jax.random.normal(k_mom, (n, dim))),
            t(jax.random.normal(k_v, (npoints, n, dim))))


def jax_fe_diff_draws(jflow, jpot, key, nsamples, batchsize=500):
    """The draws JAX's fe_diff makes from `key`."""
    k_gen, k_data, k_r0, k_r1 = jax.random.split(key, 4)
    z = np.concatenate([
        np.asarray(jflow.prior.sample(jax.random.fold_in(k_gen, i),
                                      batchsize))
        for i in range(-(-nsamples // batchsize))])
    dim = z.shape[1]
    return {"z": t(z), "x1": t(jpot.sample(k_data, nsamples)),
            "relax0": jax_relax_draws(k_r0, nsamples, dim),
            "relax1": jax_relax_draws(k_r1, nsamples, dim)}


@pytest.mark.parametrize("relaxation", [False, True])
def test_fe_diff_matches_jax(relaxation):
    jflow, p, jpot, tflow, tpot = lj_system()
    key = jax.random.PRNGKey(3)
    n = 24
    want = jfe.fe_diff(jflow, p, jpot, key, n, NP_, kT=KT,
                       relaxation=relaxation)
    got = fe_eval.fe_diff(tflow, tpot, n, NP_, kT=KT, relaxation=relaxation,
                          draws=jax_fe_diff_draws(jflow, jpot, key, n))
    close(got["Q0"], want["Q0"], rtol=1e-8, atol=1e-10, msg="Q0")
    close(got["Q1"], want["Q1"], rtol=1e-8, atol=1e-10, msg="Q1")
    for k in ("bar", "md", "nf", "emus"):
        assert np.isfinite(got[k])
        close(got[k], want[k], rtol=1e-8, atol=1e-12, msg=k)
    assert got["x0"].shape == got["x1"].shape == (n, 3 * NP_)
    if relaxation:  # the relaxed frames stay in the box
        assert np.abs(got["x0"]).max() <= BOX / 2


def test_fe_diff_no_training_matches_jax():
    jflow, p, jpot, tflow, tpot = lj_system(seed=1)
    key = jax.random.PRNGKey(5)
    n = 30
    k0, k1 = jax.random.split(key)
    want = jfe.fe_diff_no_training(jflow, p, jpot, key, n, NP_, kT=KT)
    got = fe_eval.fe_diff_no_training(
        tflow, tpot, n, NP_, kT=KT,
        draws={"x0": t(jflow.prior.sample(k0, n)),
               "x1": t(jpot.sample(k1, n))})
    close(got, want, rtol=1e-8, atol=1e-12)


def test_generate_and_evaluate_honour_any_count():
    """Ceiling division then trim: 750 rows from batches of 500, equal to
    one unbatched call on the same latents."""
    _, _, _, tflow, _ = lj_system()
    z = tflow.prior.sample(1000, generator=torch.Generator().manual_seed(0))
    x, lp = fe_eval.generate_from_nf(tflow, 750, batchsize=500, z=z)
    assert x.shape == (750, 3 * NP_) and lp.shape == (750,)
    with torch.no_grad():
        x_all, lp_all, _ = tflow.sample(z=z[:750])
    close(x, x_all, rtol=1e-12, atol=1e-14)
    close(lp, lp_all, rtol=1e-12)
    got = fe_eval.evaluate(tflow, x, batchsize=500)
    assert got.shape == (750,)
    close(got, lp, rtol=1e-9)  # log_prob(inverse(z)) = sample's log p
    drawn, _ = fe_eval.generate_from_nf(
        tflow, 7, batchsize=5, generator=torch.Generator().manual_seed(1))
    assert drawn.shape == (7, 3 * NP_)


def test_fe_diff_ntrials_and_plot(tmp_path):
    _, _, _, tflow, tpot = lj_system()
    paths = []
    for i in range(2):
        np.save(tmp_path / f"d{i}.npy", tpot.dataset.traj.numpy() + 0.01 * i)
        paths.append(str(tmp_path / f"d{i}.npy"))
    tpot.data_type = "npy"
    tpot.dataset.data_type = "npy"
    mean, std, bars = fe_eval.fe_diff_ntrials(
        tflow, tpot, 16, NP_, paths, kT=KT,
        generator=torch.Generator().manual_seed(2))
    assert bars.shape == (2,) and np.isfinite(bars).all()
    close(mean, bars.mean(), rtol=1e-12)
    pytest.importorskip("matplotlib")
    q = np.random.default_rng(0).normal(size=(10, 2))
    for split in (False, True):
        fe_eval.plot_q(q, q + 1, str(tmp_path / f"q{split}.png"), split=split)
        assert (tmp_path / f"q{split}.png").stat().st_size > 0


# ------------------------------------ tests/test_fe_eval.py on the port
def identity_flow(dim=4):
    """A DiagNormal(dim) flow through one ActNorm at its (identity) init,
    and the target N(0, I) as a one-centre GaussianMixture."""
    flow = nft.NormalizingFlow(td.DiagNormal(dim, **F64),
                               tb.Chain([tb.ActNorm(dim, **F64)]))
    target = td.GaussianMixture([[0.0] * dim], [1.0], npoints=1,
                                point_dim=dim, **F64)
    return flow, target


def test_fe_diff_relaxes_both_ensembles(monkeypatch):
    """relaxation=True relaxes the flow's frames and the data's, each with
    the same kernel: two calls, on different (16, 4) trajectories."""
    from normalizingflow_tpu_torch.mcmc import relaxation as relaxation_mod

    flow, target = identity_flow()
    calls = []
    real = relaxation_mod.relaxation_step

    def spy(fl, tg, traj, **kw):
        calls.append(traj.detach().clone())
        return real(fl, tg, traj, **kw)

    monkeypatch.setattr(relaxation_mod, "relaxation_step", spy)
    out = fe_eval.fe_diff(
        flow, target, 16, 4, relaxation=True,
        relaxation_kwargs=dict(path_len=2, step_size=1e-3, soft_factor=1.0),
        generator=torch.Generator().manual_seed(3))
    assert len(calls) == 2, "both the NF and MD ensembles must be relaxed"
    assert calls[0].shape == calls[1].shape == (16, 4)
    assert not torch.allclose(calls[0], calls[1])
    for k in ("bar", "md", "nf", "emus"):
        assert np.isfinite(out[k])


def test_relaxed_fe_diff_consistent_with_unrelaxed():
    """With a near-identity relaxation kernel the relaxed estimate agrees
    with the unrelaxed one within 0.1, and both sit near the exact 0
    (flow == target == N(0, I))."""
    flow, target = identity_flow()
    plain = fe_eval.fe_diff(flow, target, 512, 4,
                            generator=torch.Generator().manual_seed(7))
    relaxed = fe_eval.fe_diff(
        flow, target, 512, 4, relaxation=True,
        relaxation_kwargs=dict(path_len=2, step_size=1e-4, soft_factor=1.0),
        generator=torch.Generator().manual_seed(7))
    assert abs(float(plain["bar"])) < 0.1
    assert abs(float(relaxed["bar"]) - float(plain["bar"])) < 0.1
