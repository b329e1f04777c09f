"""Parity of the port's xyz I/O, trajectory dataset and Lennard-Jones target
with the JAX package, in float64.

The LJ energy and its autograd force are held to JAX at rtol 1e-12 on 8
particles with pairs across the box and beyond the cutoff, shift on and
off; the force has no NaN where pairs are excluded (self pairs, beyond the
cutoff).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.io import xyz as jxyz
from normalizingflow_tpu.targets.dataset import (
    TrajectoryDataset as JDataset,
)
from normalizingflow_tpu.targets.lj import LennardJones as JLJ

from normalizingflow_tpu_torch.io import xyz as txyz
from normalizingflow_tpu_torch.io._build import read_xyz_native
from normalizingflow_tpu_torch.targets import (
    LennardJones,
    TrajectoryDataset,
    load_trajectory,
)

torch.set_num_threads(1)

N, BOX = 8, 2.2
DATA = Path(__file__).resolve().parent.parent / "data"


def frames(n, seed=0):
    """n frames of N particles spread over the whole box, so that pairs
    cross the periodic boundary and some lie beyond the cutoff."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-BOX / 2, BOX / 2, (n, N * 3))


def test_xyz_round_trip_and_parsers_agree(tmp_path):
    x = frames(5)
    path = str(tmp_path / "t.xyz")
    txyz.write_xyz(path, x, N)
    jxyz.write_xyz(str(tmp_path / "j2.xyz"), x, N)
    assert (tmp_path / "j2.xyz").read_text() == (tmp_path / "t.xyz") \
        .read_text()
    native = read_xyz_native(path)
    python = txyz.read_xyz(path, native=False)
    assert native.shape == python.shape == (5, N, 3)
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(txyz.read_xyz(path), jxyz.read_xyz(path))
    np.testing.assert_allclose(native.reshape(5, -1), x, rtol=0, atol=5e-6)
    txyz.write_xyz(path, x[:2], N, append=True)
    assert txyz.read_xyz(path).shape == (7, N, 3)


@pytest.mark.parametrize("name", ["lj_fcc_ref.xyz", "fe_bcc_ref.xyz"])
def test_parsers_agree_on_the_shipped_lattices(name):
    path = str(DATA / name)
    native, python = read_xyz_native(path), txyz.read_xyz(path, native=False)
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native, jxyz.read_xyz(path))


def test_lammps_writer_matches_jax(tmp_path):
    x = frames(3, seed=1)
    txyz.write_lammps_coord(str(tmp_path / "t.lmp"), x, N, append=False)
    jxyz.write_lammps_coord(str(tmp_path / "j.lmp"), x, N, append=False)
    text = (tmp_path / "t.lmp").read_text()
    assert text == (tmp_path / "j.lmp").read_text()
    assert text.splitlines()[0].split()[:2] == ["1", "1"]
    assert len(text.splitlines()) == 3 * N


@pytest.mark.parametrize("kind", ["npy", "xyz", "pt"])
def test_load_trajectory_kinds(tmp_path, kind):
    x = frames(4, seed=2)
    path = str(tmp_path / f"t.{kind}")
    if kind == "npy":
        np.save(path, x)
    elif kind == "xyz":
        txyz.write_xyz(path, x, N)
    else:
        torch.save(torch.from_numpy(x), path)
    got = load_trajectory(path, kind)
    assert got.shape == (4, 3 * N)
    np.testing.assert_allclose(got, x, rtol=0,
                               atol=5e-6 if kind == "xyz" else 0)
    if kind != "pt":
        np.testing.assert_array_equal(
            got, np.asarray(JDataset(path, kind).traj))


def test_dataset_samples_the_jax_rows():
    x = frames(20, seed=3)
    jd = JDataset(data=x)
    td = TrajectoryDataset(data=x, dtype=torch.float64)
    key = jax.random.PRNGKey(4)
    idx = jax.random.randint(key, (11,), 0, 20)
    np.testing.assert_array_equal(td.sample(11, idx=np.array(idx)).numpy(),
                                  np.asarray(jd.sample(key, 11)))
    np.testing.assert_array_equal(td.sample(6, random=False).numpy(), x[:6])
    rows = td.sample(500, generator=torch.Generator().manual_seed(0))
    assert rows.shape == (500, 3 * N)
    assert len(torch.unique(rows, dim=0)) == 20  # with replacement, all hit
    td.update_data(data=x[:3], append=True)
    jd.update_data(data=x[:3], append=True)
    assert len(td) == len(jd) == 23
    td.update_data(data=x[:5])
    assert len(td) == 5 and td.dim == 3 * N
    assert len(TrajectoryDataset()) == 0


@pytest.mark.parametrize("cutoff,shift", [(1.6, True), (1.6, False),
                                          (None, True), (0.9, True)])
def test_lj_energy_and_force_match_jax(cutoff, shift):
    x = frames(16, seed=5)
    # keep every pair at r >= 0.5 so the energies are of moderate size
    pos = x.reshape(-1, N, 3)
    d = pos[:, :, None] - pos[:, None]
    d -= np.round(d / BOX) * BOX
    r = np.sqrt((d ** 2).sum(-1)) + np.eye(N) * 9
    x = x[r.min(axis=(1, 2)) > 0.5]
    assert len(x) >= 3
    kw = dict(epsilon=1.3, sigma=0.9, cutoff=cutoff, shift=shift, kT=2.0)
    jl, tl = JLJ(N, BOX, **kw), LennardJones(N, BOX, **kw)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tl.potential(tx).numpy(),
                               np.asarray(jl.potential(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(tl.log_prob(tx).numpy(),
                               np.asarray(jl.log_prob(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(tl.force(tx).numpy(),
                               np.asarray(jl.force(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    # (batch, N, 3) input gives the same energies
    np.testing.assert_array_equal(tl.potential(tx.reshape(-1, N, 3)).numpy(),
                                  tl.potential(tx).numpy())


def test_lj_pairs_across_the_box_and_beyond_the_cutoff():
    """Two particles 0.2 apart across the boundary interact; a pair beyond
    the cutoff contributes nothing (shift off) and no NaN to the force."""
    lj = LennardJones(2, BOX, cutoff=1.0, shift=False)
    near = torch.tensor([[-1.0, 0.0, 0.0, 1.0, 0.0, 0.0]],
                        dtype=torch.float64)  # 0.2 apart through the wall
    far = torch.tensor([[-0.5, 0.0, 0.0, 0.55, 0.0, 0.0]],
                       dtype=torch.float64)   # 1.05 apart: beyond 1.0
    r = 0.2
    want = 4.0 * (r ** -12 - r ** -6)
    np.testing.assert_allclose(float(lj.potential(near)), want, rtol=1e-12)
    assert float(lj.potential(far)) == 0.0
    f = lj.force(torch.cat([near, far]))
    assert bool(torch.isfinite(f).all())
    assert bool((f[1] == 0).all())
    # the force pushes the near pair apart through the wall: particle 1's
    # image sits just left of particle 0
    assert float(f[0, 3]) < 0 < float(f[0, 0])


def test_lj_force_has_no_nan_at_self_pairs():
    """Self pairs (r = 0) and pairs beyond the cutoff are excluded before
    the divide: with every pair excluded, energy and force are exactly 0,
    not NaN."""
    lj = LennardJones(3, BOX, cutoff=0.5)
    x = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 0.9, 0.9, 0.0, 0.0]],
                     dtype=torch.float64)
    f = lj.force(x)
    assert bool(torch.isfinite(f).all()) and bool((f == 0).all())
    assert float(lj.potential(x)) == 0.0


def test_lj_samples_its_attached_data(tmp_path):
    x = frames(6, seed=6)
    np.save(tmp_path / "d.npy", x)
    lj = LennardJones(N, BOX, pos_dir=str(tmp_path / "d.npy"),
                      data_type="npy", dtype=torch.float64)
    np.testing.assert_array_equal(lj.sample(3, idx=[5, 0, 5]).numpy(),
                                  x[[5, 0, 5]])
    bare = LennardJones(N, BOX)
    with pytest.raises(ValueError, match="no attached trajectory"):
        bare.sample(2)
    bare.update_data(data=x)
    assert bare.sample(4, generator=torch.Generator()).shape == (4, 3 * N)
    bare.update_data(data=x[:2], append=True)
    assert len(bare.dataset) == 8


def test_malformed_file_raises_native(tmp_path):
    """A truncated row: the C++ parser raises OSError."""
    path = tmp_path / "bad.xyz"
    path.write_text("4\n comment\n1 0.0 0.0\n")
    with pytest.raises(OSError):
        read_xyz_native(str(path))


def test_native_parser_speed(tmp_path):
    """The C++ parser reads 400 frames of 54 atoms faster than the Python
    one (both after a warm read)."""
    import time

    path = str(tmp_path / "big.xyz")
    x = np.random.default_rng(1).normal(size=(400, 54 * 3))
    txyz.write_xyz(path, x, 54)
    read_xyz_native(path)  # the build and the page cache
    t0 = time.perf_counter()
    read_xyz_native(path)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    txyz.read_xyz(path, native=False)
    t_python = time.perf_counter() - t0
    assert t_native < t_python, (t_native, t_python)
