"""Parity of the port's Gaussian free field (targets/gff.py) with the JAX
package's, in float64, and the port's apps.polymer end to end.

The action, eigenvalues, normalizer and log_prob are held to JAX at rtol
1e-12. The two packages draw different numbers (JAX's FFT runs on the host
CPU from a threefry key, the port's on the target's device from a
torch.Generator), so the port's samples are checked in law: the mean action
of 20000 draws within 4 sigma of dim/2 (the action is a sum of dim
independent chi^2_1 / 2, variance dim/2), and every entry of the empirical
covariance within 5 of its standard errors of the exact inverse precision.
apps.polymer runs data -> training -> testing on a 2 x 4 x 4 field with
`device: cpu` and writes finite numbers.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.apps.polymer import field_shape as j_field_shape
from normalizingflow_tpu.config import load_config as j_load_config
from normalizingflow_tpu.targets.gff import GaussianField as JGFF
from normalizingflow_tpu.targets.gff import gff_action as j_action

from normalizingflow_tpu_torch.apps import polymer
from normalizingflow_tpu_torch.config import DatasetConfig, build_potential
from normalizingflow_tpu_torch.config import load_config
from normalizingflow_tpu_torch.targets import GaussianField, gff_action

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.mark.parametrize("L,channels,mass", [(4, 2, (0.5, 1.0)),
                                             (5, 1, 0.7), (8, 3, (0.3, 1.0,
                                                                  2.0))])
def test_gff_matches_jax(L, channels, mass):
    gff = GaussianField(L, channels, mass, dtype=torch.float64)
    jgff = JGFF(L, channels, mass)
    np.testing.assert_allclose(gff.eigenvalues.numpy(),
                               np.asarray(jgff.eigenvalues), rtol=1e-12)
    assert isinstance(gff.log_norm, float)
    np.testing.assert_allclose(gff.log_norm, jgff.log_norm, rtol=1e-12)
    x = np.random.default_rng(L).standard_normal((6, gff.dim))
    np.testing.assert_allclose(
        gff.log_prob(torch.from_numpy(x)).numpy(),
        np.asarray(jgff.log_prob(jnp.asarray(x))), rtol=1e-12)
    w = x[:, :L * L].reshape(-1, L, L)
    np.testing.assert_allclose(
        gff_action(torch.from_numpy(w), 0.9).numpy(),
        np.asarray(jax.vmap(lambda f: j_action(f, 0.9))(jnp.asarray(w))),
        rtol=1e-12)


def test_gff_masses_must_match_channels():
    with pytest.raises(ValueError, match="need 2 masses"):
        GaussianField(4, 2, (0.5, 1.0, 2.0))


def test_gff_samples_in_law():
    gff = GaussianField(4, 2, (0.5, 1.0), dtype=torch.float64)
    n, dim = 20000, gff.dim
    x = gff.sample(n, generator=torch.Generator().manual_seed(0))
    assert x.shape == (n, dim) and x.dtype == torch.float64
    assert gff.sample(3, flatten=False).shape == (3, 2, 4, 4)
    action = gff.potential(x)
    sigma = math.sqrt(dim / 2 / n)
    assert abs(float(action.mean()) - dim / 2) < 4 * sigma
    # exact covariance: the inverse of the action's (constant) Hessian
    prec = torch.autograd.functional.hessian(
        lambda v: gff.potential(v[None])[0], torch.zeros(dim,
                                                         dtype=torch.float64))
    cov = torch.linalg.inv(prec)
    emp = x.T @ x / n
    d = torch.diagonal(cov)
    se = torch.sqrt((d[:, None] * d[None, :] + cov * cov) / n)
    assert bool(((emp - cov).abs() < 5 * se).all()), \
        float(((emp - cov).abs() / se).max())
    # the normalizer is the dense Gaussian's
    np.testing.assert_allclose(
        gff.log_norm, 0.5 * float(torch.logdet(prec))
        - 0.5 * dim * math.log(2 * math.pi), rtol=1e-12)


def test_config_gaussian_field_branch():
    ds = DatasetConfig(potential="GaussianField", L=4, channels=2)
    gff = build_potential("GaussianField", ds, ds, dtype=torch.float64)
    assert (gff.L, gff.channels, gff.mass) == (4, 2, (0.5, 1.0))


def test_field_shape_and_its_error():
    cfg = load_config(os.path.join(ROOT, "configs", "Polymer.yaml"))
    jcfg = j_load_config(os.path.join(ROOT, "configs", "Polymer.yaml"))
    assert polymer.field_shape(cfg) == j_field_shape(jcfg) == (2, 32, 32)
    cfg.dataset.nparticles = 30  # 30 = 2 x 15: not 2 x L x L
    with pytest.raises(ValueError, match="not channels x L x L"):
        polymer.field_shape(cfg)


TINY_POLYMER = """device: cpu
dataset:
  name: PolyTiny
  potential: SimData
  training_data: {d}/data/field.npy
  testing_data: {d}/data/field_test.npy
  type: npy
  nparticles: 32
  dim: 1
  boxlength: 8
flow:
  type: NSF_AR
  nlayers: 2
  nsplines: 4
  hidden_dim: 8
  periodic: false
prior:
  type: Normal
  nparticles: 32
  dim: 1
  vars: 0.1
train_parameters:
  max_epochs: 60
  batch_size: 16
  learning_rate: 1e-3
  scheduler: cosine
output:
  training_dir: {d}/training/
  testing_dir: {d}/testing/
  model_dir: {d}/models/
"""


def test_polymer_cli_end_to_end(tmp_path, capsys):
    """apps.polymer data -> training -> testing on 2 x 4 x 4 fields on the
    CPU: the files are written and every number is finite."""
    cfg = tmp_path / "poly.yaml"
    cfg.write_text(TINY_POLYMER.format(d=tmp_path))
    assert polymer.main([str(cfg), "data", "150"]) == 0
    train = np.load(tmp_path / "data" / "field.npy")
    test = np.load(tmp_path / "data" / "field_test.npy")
    assert train.shape == (120, 32) and test.shape == (30, 32)
    assert np.isfinite(train).all() and "exact logp" in \
        capsys.readouterr().out

    assert polymer.main([str(cfg), "training"]) == 0
    assert (tmp_path / "models" / "PolyTiny.pt").exists()
    assert "Adam mu float32" in capsys.readouterr().out

    assert polymer.main([str(cfg), "testing"]) == 0
    out = capsys.readouterr().out
    assert "sampling latency" in out and "flow - exact gap" in out
    fields = np.load(tmp_path / "testing" / "generated_fields.npy")
    assert fields.shape == (polymer.NSAMPLES, 2, 4, 4)
    assert np.isfinite(fields).all()
    rec = np.load(tmp_path / "testing" / "polymer_PolyTiny_testing.npz")
    for k in ("sample_s_hot", "sample_s_first", "logp_generated",
              "logp_data", "logp_exact", "gap"):
        assert np.isfinite(rec[k]), k
    np.testing.assert_allclose(rec["gap"], rec["logp_data"]
                               - rec["logp_exact"], rtol=1e-12)
    assert polymer.main([str(cfg)]) == 2
    assert polymer.main([str(cfg), "plot"]) == 2
