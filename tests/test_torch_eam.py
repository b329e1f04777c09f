"""Parity of the port's EAM iron target (targets/eam.py) with the JAX
package's, in float64.

The spline coefficients and the parsed setfl tables equal JAX's exactly
(both are numpy float64). Energies and autograd forces of both the analytic
Finnis-Sinclair model and the tabulated path are held to JAX (`take`
lookup, `jax.grad`) at rtol 1e-12 on batches of noisy bcc frames; so is a
table whose F(rho) grid ends below the frames' densities, where the last
cubic is extrapolated. Table against analytic keeps tests/test_eam.py's
bars: 5e-4 eV on energies, 2e-3 of the largest force on forces.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.config import DatasetConfig as JDatasetConfig
from normalizingflow_tpu.config import build_potential as j_build_potential
from normalizingflow_tpu.targets import eam as je
import tools.make_setfl as mk

from normalizingflow_tpu_torch.config import DatasetConfig, build_potential
from normalizingflow_tpu_torch.io import read_xyz
from normalizingflow_tpu_torch.targets import eam as te

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SETFL = os.path.join(ROOT, "data", "fe_fs.setfl")
REF_XYZ = os.path.join(ROOT, "data", "fe_bcc_ref.xyz")
BOX = 3 * 2.9115                 # Fe_400K's cell
KT_400K = 0.034469333048         # Fe_400K's kT (eV)
N = 54


def bcc_frames(n, noise=0.08, seed=0):
    """(n, 54, 3) noisy frames around the shipped bcc lattice."""
    lattice = read_xyz(REF_XYZ).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    return lattice[None] + noise * rng.standard_normal((n,) + lattice.shape)


def jax_energy_and_force(energy, frames):
    """JAX's per-frame energies and -grad, vmapped over the batch."""
    x = jnp.asarray(frames)
    e = jax.vmap(energy)(x)
    g = jax.vmap(jax.grad(energy))(x)
    return np.asarray(e), -np.asarray(g)


def port_energy_and_force(energy, frames):
    x = torch.from_numpy(frames).requires_grad_(True)
    e = energy(x)
    (g,) = torch.autograd.grad(e.sum(), x)
    return e.detach().numpy(), -g.numpy()


def assert_energy_force(port, jax_, frames):
    e, f = port_energy_and_force(port, frames)
    je_, jf = jax_energy_and_force(jax_, frames)
    np.testing.assert_allclose(e, je_, rtol=1e-12)
    np.testing.assert_allclose(f, jf, rtol=1e-12,
                               atol=1e-12 * np.abs(jf).max())


@pytest.mark.parametrize("n", [3, 17, 400])
def test_natural_cubic_coeffs_equal_jax(n):
    rng = np.random.default_rng(n)
    y = np.cumsum(rng.standard_normal(n))
    np.testing.assert_array_equal(te._natural_cubic_coeffs(y, 0.03),
                                  np.asarray(je._natural_cubic_coeffs(y,
                                                                      0.03)))


def test_load_setfl_equals_jax():
    t, j = te.load_setfl(SETFL), je.load_setfl(SETFL)
    for k in te.SPLINES:
        assert t[k].dtype == np.float64 and t[k].shape == (1999, 4)
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    for k in ("drho", "dr", "cutoff"):
        assert t[k] == j[k]
    assert set(t) == set(te.SPLINES) | {"drho", "dr", "cutoff"}


def test_truncated_setfl_raises(tmp_path):
    path = str(tmp_path / "tiny.setfl")
    mk.write_setfl(path, nr=50, nrho=50, rho_max=40.0)
    with open(path) as fh:
        lines = fh.read().split("\n")
    with open(path, "w") as fh:
        fh.write("\n".join(lines[:20]))
    with pytest.raises(ValueError, match="expected"):
        te.load_setfl(path)


@pytest.mark.parametrize("box", [BOX, None])
def test_fs_iron_energy_and_force_match_jax(box):
    assert_energy_force(lambda x: te.fs_iron_energy(x, box),
                        lambda p: je.fs_iron_energy(p, box), bcc_frames(5))


def test_tabulated_energy_and_force_match_jax():
    tables, jtables = te.load_setfl(SETFL), je.load_setfl(SETFL)
    assert_energy_force(
        lambda x: te.tabulated_eam_energy(x, BOX, tables),
        lambda p: je.tabulated_eam_energy(p, BOX, jtables, impl="take"),
        bcc_frames(5, seed=1))


def test_rho_past_the_table_extrapolates_the_last_cubic(tmp_path):
    """F(rho) tabulated only up to rho 5; the frames' densities are 5.3-6.4,
    so the embedding reads the last segment's cubic beyond its end, and its
    derivative there, as JAX's `take` does."""
    path = str(tmp_path / "short.setfl")
    mk.write_setfl(path, nr=300, nrho=50, rho_max=5.0)
    tables, jtables = te.load_setfl(path), je.load_setfl(path)
    frames = bcc_frames(4, seed=2)
    pos = torch.from_numpy(frames)
    r, eye = te._pair_distances(pos, BOX)
    psi = te._spline_eval(torch.from_numpy(tables["rho_spl"]), tables["dr"],
                          torch.where(r < tables["cutoff"], r,
                                      torch.full_like(r, tables["cutoff"])))
    rho = torch.where((r < tables["cutoff"]) & ~eye, psi, 0 * psi).sum(-1)
    n_seg = tables["f_spl"].shape[0]
    assert float(rho.min()) > n_seg * tables["drho"]  # all past the table
    assert_energy_force(
        lambda x: te.tabulated_eam_energy(x, BOX, tables),
        lambda p: je.tabulated_eam_energy(p, BOX, jtables, impl="take"),
        frames)
    # the lookup itself, and its derivative, past the end of the grid
    x = torch.linspace(4.9, 7.0, 23, dtype=torch.float64,
                       requires_grad=True)
    f = te._spline_eval(torch.from_numpy(tables["f_spl"]), tables["drho"], x)
    (g,) = torch.autograd.grad(f.sum(), x)
    spline = (lambda v: je._spline_eval(jtables["f_spl"], jtables["drho"], v,
                                        impl="take"))
    xj = jnp.asarray(x.detach().numpy())
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(spline(xj)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.vmap(jax.grad(spline))(xj)), rtol=1e-12)


def test_table_against_analytic():
    """The shipped table tabulates the analytic model: tests/test_eam.py's
    bars on energies and forces."""
    tables = te.load_setfl(SETFL)
    frames = bcc_frames(6, seed=3)
    e_tab, f_tab = port_energy_and_force(
        lambda x: te.tabulated_eam_energy(x, BOX, tables), frames)
    e_fs, f_fs = port_energy_and_force(lambda x: te.fs_iron_energy(x, BOX),
                                       frames)
    np.testing.assert_allclose(e_tab, e_fs, rtol=0, atol=5e-4)
    assert np.isfinite(f_tab).all()
    assert np.abs(f_tab - f_fs).max() < 2e-3 * max(np.abs(f_fs).max(), 1.0)


@pytest.mark.parametrize("table", [True, False])
def test_eamiron_log_prob_matches_jax(table):
    """EAMIron at Fe_400K's kT: log_prob, force and flat/(batch, n, 3)
    inputs."""
    path = SETFL if table else None
    fe = te.EAMIron(N, boxlength=BOX, kT=KT_400K, setfl_path=path,
                    dtype=torch.float64)
    jfe = je.EAMIron(N, boxlength=BOX, kT=KT_400K, setfl_path=path,
                     spline_impl="take")
    frames = bcc_frames(4, seed=4).reshape(4, -1)
    x = torch.from_numpy(frames)
    np.testing.assert_allclose(fe.log_prob(x).numpy(),
                               np.asarray(jfe.log_prob(jnp.asarray(frames))),
                               rtol=1e-12)
    jforce = -np.asarray(jax.vmap(jax.grad(
        lambda f: jfe.potential(f[None])[0]))(jnp.asarray(frames)))
    np.testing.assert_allclose(fe.force(x).numpy(), jforce, rtol=1e-12,
                               atol=1e-12 * np.abs(jforce).max())
    np.testing.assert_array_equal(fe.potential(x.reshape(4, N, 3)).numpy(),
                                  fe.potential(x).numpy())
    if table:
        assert fe.tables["f_spl"].dtype == torch.float64


def test_eamiron_samples_its_attached_data(tmp_path):
    frames = bcc_frames(6, seed=5).reshape(6, -1)
    np.save(tmp_path / "d.npy", frames)
    fe = te.EAMIron(N, boxlength=BOX, pos_dir=str(tmp_path / "d.npy"),
                    data_type="npy", dtype=torch.float64)
    np.testing.assert_array_equal(fe.sample(3, idx=[5, 0, 5]).numpy(),
                                  frames[[5, 0, 5]])
    bare = te.EAMIron(N, boxlength=BOX)
    with pytest.raises(ValueError, match="no attached trajectory"):
        bare.sample(2)
    bare.update_data(data=frames)
    bare.update_data(data=frames[:2], append=True)
    assert len(bare.dataset) == 8


def test_config_fe_branch(tmp_path):
    """dataset.input_dir -> the setfl table; a missing file raises; no
    input_dir -> the analytic model: as JAX's config.py."""
    kw = dict(potential="Fe", nparticles=N, kT=KT_400K)
    ds = DatasetConfig(input_dir=SETFL, **kw)
    fe = build_potential("Fe", ds, ds, boxlength=BOX, dtype=torch.float64)
    jfe = j_build_potential("Fe", JDatasetConfig(input_dir=SETFL, **kw),
                            JDatasetConfig(input_dir=SETFL, **kw),
                            boxlength=BOX)
    assert fe.tables is not None and fe.boxlength == jfe.boxlength
    frames = bcc_frames(2, seed=6).reshape(2, -1)
    np.testing.assert_allclose(
        fe.potential(torch.from_numpy(frames)).numpy(),
        np.asarray(jfe.potential(jnp.asarray(frames))), rtol=1e-12)
    missing = DatasetConfig(input_dir=str(tmp_path / "nope.setfl"), **kw)
    with pytest.raises(FileNotFoundError, match="setfl"):
        build_potential("Fe", missing, missing, boxlength=BOX)
    bare = DatasetConfig(**kw)
    assert build_potential("Fe", bare, bare, boxlength=BOX).tables is None
