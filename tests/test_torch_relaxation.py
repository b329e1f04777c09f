"""Parity of the port's relaxation (mcmc/relaxation.py) with the JAX
package, in float64, on JAX's own draws.

`relaxation_step`, `integrate_out_v` and `metropolize` match at rtol 1e-10;
`collect_hmc_data` replays JAX's flow latents and HMC draws, and the
training diagnostics (train/diagnostics.py) take JAX's latents. The
displacement cap keeps a frame with overlapping particles finite in
float32, where |grad U| is about 1e10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.mcmc import relaxation as jrel
from normalizingflow_tpu.mcmc.hmc import padded_length as j_padded_length
from normalizingflow_tpu.targets.lj import LennardJones as JLJ

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.io import read_xyz
from normalizingflow_tpu_torch.mcmc import (
    collect_hmc_data,
    integrate_out_v,
    metropolize,
    relaxation_step,
)
from normalizingflow_tpu_torch.targets import LennardJones

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
NP_, KT, ALPHA = 4, 2.0, 100.0
HALF = (NP_ / (8 * 1.28)) ** (1 / 3)
BOX = 2 * HALF
CENTERS = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
           * BOX - BOX / 4).astype(np.float32).astype(np.float64)
DIM = 3 * NP_
RTOL, ATOL = 1e-10, 1e-12


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(actual, expected, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().numpy()
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


def system(seed=0):
    kw = dict(num_bins=4, tail_bound=HALF, hidden_dim=8)
    jflow = JFlow(jd.EinsteinCrystal(CENTERS, ALPHA, boxlength=BOX),
                  jb.Chain([jb.SplineAR(DIM, **kw) for _ in range(2)]))
    tflow = nft.NormalizingFlow(
        td.EinsteinCrystal(CENTERS, ALPHA, boxlength=BOX, **F64),
        tb.Chain([tb.SplineAR(DIM, **kw, **F64) for _ in range(2)]))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return (jflow, p, JLJ(NP_, BOX, cutoff=1.6, kT=KT), tflow,
            LennardJones(NP_, BOX, cutoff=1.6, kT=KT, **F64))


def lattice_frames(n, seed, scale=0.04):
    rng = np.random.default_rng(seed)
    return CENTERS.reshape(1, -1) + scale * rng.standard_normal((n, DIM))


RELAX_KW = [dict(), dict(path_len=5, step_size=2e-3, soft_factor=50.0,
                         max_disp=0.01, damping=0.8)]


@pytest.mark.parametrize("kw", RELAX_KW, ids=["default", "custom"])
def test_relaxation_step_matches_jax(kw):
    jflow, p, jlj, tflow, tlj = system()
    traj = lattice_frames(12, 1)
    key = jax.random.PRNGKey(2)
    want = jrel.relaxation_step(key, jflow, p, jlj, jnp.asarray(traj),
                                kT=KT, **kw)
    k_mom, k_v = jax.random.split(key)
    draws = (t(jax.random.normal(k_mom, traj.shape)),
             t(jax.random.normal(k_v, (10,) + traj.shape)))
    got = relaxation_step(tflow, tlj, t(traj), kT=KT, draws=draws, **kw)
    for name in got._fields:
        close(getattr(got, name), getattr(want, name), msg=name)
    assert not np.allclose(got.positions.numpy(), traj)  # it moved


def test_integrate_out_v_matches_jax():
    jflow, p, jlj, tflow, tlj = system(seed=3)
    frames = lattice_frames(9, 4)
    key = jax.random.PRNGKey(5)
    kw = dict(npoints=6, path_len=4, step_size=1e-3, soft_factor=200.0)
    want = jrel.integrate_out_v(key, jflow, p, jlj, jnp.asarray(frames),
                                kT=KT, **kw)
    normal = t(jax.random.normal(key, (6,) + frames.shape))
    got = integrate_out_v(tflow, tlj, t(frames), kT=KT, normal=normal, **kw)
    close(got, want)
    drawn = integrate_out_v(tflow, tlj, t(frames), kT=KT,
                            generator=torch.Generator().manual_seed(0), **kw)
    assert drawn.shape == (9,) and bool(torch.isfinite(drawn).all())


def test_metropolize_matches_jax():
    _, _, jlj, _, tlj = system()
    x = np.concatenate([lattice_frames(30, 6),
                        lattice_frames(30, 7, scale=0.15)])
    key = jax.random.PRNGKey(8)
    mask, energies = jrel.metropolize(key, jlj, jnp.asarray(x), kT=KT,
                                      burnin=5)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(
        jax.random.split(key, len(x)))
    tmask, tenergies = metropolize(tlj, t(x), kT=KT, burnin=5, u=t(u))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    close(tenergies, energies)
    assert 0 < int(tmask.sum()) < len(x) - 5


def test_cap_keeps_an_overlapping_frame_finite_in_float32():
    """Two particles 0.2 apart: |grad U| ~ 1e10 in float32. Every step's
    displacement is capped, so each coordinate moves at most path_len *
    max_disp and every output is finite."""
    _, _, _, tflow, _ = system()
    tflow = tflow.float()
    lj = LennardJones(NP_, BOX, cutoff=1.6, kT=KT)
    frames = torch.tensor(lattice_frames(6, 9), dtype=torch.float32)
    frames[:, 3:6] = frames[:, 0:3] + torch.tensor([0.2, 0.0, 0.0])
    g = lj.force(frames)
    assert float(g.abs().max()) > 1e9
    res = relaxation_step(tflow, lj, frames, kT=KT, path_len=12,
                          max_disp=0.05,
                          generator=torch.Generator().manual_seed(0))
    for name in res._fields:
        assert bool(torch.isfinite(getattr(res, name)).all()), name
    move = res.positions - frames
    move = move - torch.round(move / BOX) * BOX  # undo a wrap
    assert float(move.abs().max()) <= 12 * 0.05 + 1e-5
    assert bool((res.q_energy > res.q_energy_before).all())


def jax_hmc_draws(key, chains, dim, num_samples):
    """The raw draws of JAX's run_hmc without warmup (thin 1), in the
    order the port's run_hmc consumes them."""
    @jax.jit
    def draws(k):
        def one(kc):
            k_mom, k_acc, k_eps = jax.random.split(kc, 3)
            return (jax.random.uniform(k_eps, (), jnp.float64, -1.0, 1.0),
                    jax.random.normal(k_mom, (dim,), jnp.float64),
                    jax.random.uniform(k_acc, (), jnp.float64))
        u, normal, ua = jax.vmap(one)(jax.random.split(k, chains))
        return u[:, None], normal, ua

    return [tuple(t(a) for a in draws(k))
            for k in jax.random.split(key, j_padded_length(num_samples))]


def test_collect_hmc_data_matches_jax(tmp_path):
    jflow, p, jlj, tflow, tlj = system(seed=5)
    key = jax.random.PRNGKey(10)
    kw = dict(n_chains=3, n_steps=20, burnin=5, step_size=0.01,
              num_leapfrog=3)
    data, acc = jrel.collect_hmc_data(key, jflow, p, jlj, **kw)
    k_sample, k_run = jax.random.split(key)
    z = t(jflow.prior.sample(k_sample, 3))
    tdata, tacc = collect_hmc_data(
        tflow, tlj, z=z, draws=jax_hmc_draws(k_run, 3, DIM, 20),
        output_dir=str(tmp_path), device="cpu", **kw)
    assert tdata.shape == (15 * 3, DIM)
    close(tdata, data, rtol=1e-8, atol=1e-10)
    close(tacc, acc, rtol=1e-8)
    assert float(tdata.abs().max()) <= BOX / 2
    relaxed = read_xyz(str(tmp_path / "relaxed_configs.xyz"))
    seeds = read_xyz(str(tmp_path / "generated_configs.xyz"))
    assert relaxed.reshape(len(relaxed), -1).shape == tdata.shape
    assert seeds.shape == (3, NP_, 3)


def test_collect_hmc_data_draws_from_a_generator():
    _, _, _, tflow, tlj = system()
    data, acc = collect_hmc_data(
        tflow, tlj, n_chains=2, n_steps=6, burnin=2, step_size=0.01,
        num_leapfrog=2, kT=2.0, generator=torch.Generator().manual_seed(0),
        device="cpu")
    assert data.shape == (8, DIM) and bool(torch.isfinite(data).all())
    assert 0.0 <= float(acc) <= 1.0


def test_diagnostics_match_jax():
    """force_matching and held_out_logprob_gap (train/diagnostics.py) on the
    LJ system, the flow's latents injected."""
    from normalizingflow_tpu.train import diagnostics as jdiag

    from normalizingflow_tpu_torch.train import diagnostics

    jflow, p, jlj, tflow, tlj = system(seed=6)
    x = lattice_frames(10, 11)
    close(diagnostics.force_matching(tflow, tlj, t(x), kT=KT),
          jdiag.force_matching(jflow, p, jlj, jnp.asarray(x), kT=KT))
    key = jax.random.PRNGKey(12)
    want = jdiag.held_out_logprob_gap(jflow, p, key, jnp.asarray(x),
                                      nsamples=7)
    got = diagnostics.held_out_logprob_gap(
        tflow, t(x), nsamples=7, z=t(jflow.prior.sample(key, 7)))
    for a, b in zip(got, want):
        close(a, b)
    drawn = diagnostics.held_out_logprob_gap(
        tflow, t(x), generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in drawn)
