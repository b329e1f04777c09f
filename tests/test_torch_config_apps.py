"""The port's config parsing, model factories and CLI apps, against the JAX
package's.

Every file in configs/ parses to JAX's values; every config builds (on the
meta device, so the 2048-dim Polymer stacks take no memory) with JAX's
Repeat/Chain choice, parameter count and target; an LJ-shaped flow built
from LJ.yaml takes JAX's weights and gives JAX's densities at rtol 1e-10;
and the whole CLI pipeline (sample_data -> train -> test -> fe) runs on a
4-particle LJ solid with `device: cpu` and ends with finite estimates.
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import normalizingflow_tpu.config as jconfig
from normalizingflow_tpu.bijectors import Repeat as JRepeat

import normalizingflow_tpu_torch.config as tconfig
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.bijectors import Chain, Repeat

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ALL_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
# targets that sample only from a trajectory file
DATA_BACKED = {"LJ", "SimData", "Fe", "Phi4"}


@pytest.fixture(autouse=True)
def repo_root(monkeypatch):
    """The configs name data/ relative to the repository's root."""
    monkeypatch.chdir(ROOT)


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=os.path.basename)
def test_config_parses_to_the_jax_values(path):
    assert tconfig.jax_schema(tconfig.load_config(path)) == \
        dataclasses.asdict(jconfig.load_config(path))


def n_params_jax(bij):
    shapes = jax.eval_shape(bij.init, jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=os.path.basename)
def test_config_builds_or_names_what_is_missing(path):
    cfg = tconfig.load_config(path)
    jcfg = jconfig.load_config(path)
    b, box = tconfig.infer_boxlength(cfg.dataset)
    assert (b, box) == jconfig.infer_boxlength(jcfg.dataset)
    meta = dict(device="meta", dtype=torch.float32)
    prior = tconfig.build_potential(cfg.prior.type, cfg.prior, cfg.dataset,
                                    boxlength=box, **meta)
    assert prior.dim == cfg.dataset.nparticles * cfg.dataset.dim
    stack = tconfig.build_flow_stack(cfg, b, **meta)
    jstack = jconfig.build_flow_stack(jcfg, b)
    assert isinstance(stack, Repeat) == isinstance(jstack, JRepeat)
    assert sum(p.numel() for p in stack.parameters()) == \
        n_params_jax(jstack)
    if cfg.dataset.potential == "SimData":
        return  # needs the trajectory file; the model part is checked above
    _, potential, cfg2 = tconfig.setup_model(cfg, device="meta")
    _, jpotential, jcfg2 = jconfig.setup_model(jcfg)
    assert tconfig.jax_schema(cfg2) == dataclasses.asdict(jcfg2)
    assert type(potential).__name__ == type(jpotential).__name__
    assert potential.dim == jpotential.dim == prior.dim
    assert getattr(potential, "boxlength", None) == \
        getattr(jpotential, "boxlength", None)
    if cfg.dataset.potential in DATA_BACKED:
        return  # samples need trajectory files
    flow, potential, cfg2 = tconfig.setup_model(cfg, device="cpu",
                                                dtype=torch.float64)
    x = potential.sample(3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lp = flow.log_prob(x)
    assert lp.shape == (3,) and bool(torch.isfinite(lp).all())


@pytest.mark.parametrize("kind,nlayers,hidden,repeat", [
    ("RealNVP", 3, 16, False), ("RealNVP", 4, 16, True),
    ("RealNVP", 4, 6000, False),  # est. params >= 2e8: unrolled
    ("NSF_AR", 3, 8, False), ("NSF_AR", 4, 8, True),
    ("NSF_CL", 6, 8, False), ("MAF", 2, 8, False), ("ActNorm", 2, 8, False)])
def test_repeat_chain_switch(kind, nlayers, hidden, repeat):
    raw = {"dataset": {"nparticles": 32, "dim": 3},
           "flow": {"type": kind, "nlayers": nlayers, "hidden_dim": hidden,
                    "nsplines": 4}}
    cfg = tconfig._merge_dataclass(tconfig.Config(), raw)
    jcfg = jconfig._merge_dataclass(jconfig.Config(), raw)
    stack = tconfig.build_flow_stack(cfg, 1.0, device="meta")
    jstack = jconfig.build_flow_stack(jcfg, 1.0)
    assert isinstance(stack, Repeat) is repeat
    assert isinstance(jstack, JRepeat) is repeat
    assert isinstance(stack, Chain) and len(stack.bijectors) == nlayers
    if kind == "NSF_CL":
        assert [layer.mask for layer in stack.bijectors] == \
            [(0,), (1,), (2,), (0, 1), (1, 2), (0, 2)]


@pytest.mark.parametrize("kind", ["Planar", "Radial", "OneByOneConv"])
def test_unported_flows_name_their_item(kind):
    """Item 13 is ported: the three flows build (on the CPU, as the LU of
    OneByOneConv's init needs data), with JAX's parameter count; an
    unknown type still raises."""
    cfg = tconfig._merge_dataclass(tconfig.Config(),
                                   {"flow": {"type": kind}})
    stack = tconfig.build_flow_stack(cfg, 1.0, device="cpu")
    jstack = jconfig.build_flow_stack(
        jconfig._merge_dataclass(jconfig.Config(), {"flow": {"type": kind}}),
        1.0)
    assert sum(p.numel() for p in stack.parameters()) == \
        n_params_jax(jstack)
    with pytest.raises(KeyError, match="unknown flow type"):
        tconfig.build_flow_stack(tconfig._merge_dataclass(
            tconfig.Config(), {"flow": {"type": "Glow"}}), 1.0)


def test_config_rejects_unknown_keys_and_reads_strings(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("train_parameters:\n  learning_rate: '3e-4'\n")
    assert tconfig.load_config(str(path)).train_parameters.learning_rate \
        == 3e-4
    path.write_text("flow:\n  depth: 3\n")
    with pytest.raises(KeyError, match="unknown config key 'depth'"):
        tconfig.load_config(str(path))


@pytest.mark.parametrize("mode", ["training", "testing"])
def test_lj_shaped_flow_matches_jax(mode):
    """LJ.yaml at its 32 particles, with narrow layers: both packages'
    setup_model, JAX's weights carried over, the same densities and
    samples."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "LJ.yaml")))
    raw["flow"].update(hidden_dim=8, nsplines=4)
    cfg = tconfig._merge_dataclass(tconfig.Config(), raw)
    jcfg = jconfig._merge_dataclass(jconfig.Config(), raw)
    flow, pot, _ = tconfig.setup_model(cfg, mode, device="cpu",
                                       dtype=torch.float64)
    jflow, jpot, _ = jconfig.setup_model(jcfg, mode)
    assert pot.boxlength == jpot.boxlength and pot.cutoff == jpot.cutoff
    p = jax.tree.map(lambda a: jax.numpy.asarray(a, np.float64),
                     jflow.init(jax.random.PRNGKey(1)))
    tparams.from_jax(flow, p)
    # the JAX EinsteinCrystal keeps its lattice in float32 even under x64
    flow.prior.centers.copy_(torch.from_numpy(
        np.asarray(jflow.prior.centers, np.float64)))
    key = jax.random.PRNGKey(2)
    jx, jlp, jz = jflow.sample(p, key, 6)
    z = torch.from_numpy(np.array(jz, np.float64))
    with torch.no_grad():
        x, lp, _ = flow.sample(z=z)
        dens = flow.log_prob(x)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10)
    np.testing.assert_allclose(
        dens.numpy(), np.asarray(jflow.log_prob(p, jx)), rtol=1e-10)
    np.testing.assert_allclose(pot.potential(x).numpy(),
                               np.asarray(jpot.potential(jx)), rtol=1e-10)


TINY_LJ = """device: cpu
dataset:
  name: LJtiny
  potential: LJ
  training_data: {d}/data/train.npy
  testing_data: {d}/data/test.npy
  type: npy
  nparticles: 4
  kT: 0.5
  rho: 1.28
  cutoff: 1.6
flow:
  type: NSF_AR
  nlayers: 2
  nsplines: 4
  hidden_dim: 8
prior:
  type: EinsteinCrystal
  centers: {d}/lattice.xyz
  alpha: 100
train_parameters:
  max_epochs: 400
  batch_size: 16
  learning_rate: 1e-3
  scheduler: cosine
output:
  training_dir: {d}/training/
  testing_dir: {d}/testing/
  model_dir: {d}/models/
"""


def test_cli_pipeline_on_a_tiny_lj_solid(tmp_path, capsys):
    """sample_data -> train -> test -> fe on a one-cell fcc LJ solid (4
    particles at rho 1.28, kT 0.5) on the CPU: every step writes its files
    and the estimates are finite."""
    from normalizingflow_tpu_torch.apps import fe, sample_data, test, train
    from normalizingflow_tpu_torch.io import write_xyz

    box = 2 * (4 / (8 * 1.28)) ** (1 / 3)
    lattice = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
               * box - box / 4)
    write_xyz(str(tmp_path / "lattice.xyz"), lattice[None], 4)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_LJ.format(d=tmp_path))

    assert sample_data.main([str(cfg), "64"]) == 0
    frames = np.load(tmp_path / "data" / "train.npy")
    assert frames.shape == (51, 12) and np.isfinite(frames).all()
    assert np.abs(frames).max() <= box / 2
    assert np.load(tmp_path / "data" / "test.npy").shape == (13, 12)
    assert "HMC acceptance" in capsys.readouterr().out

    assert train.main([str(cfg)]) == 0
    models = tmp_path / "models"
    assert (models / "LJtiny.pt").exists()
    assert (models / "LJtiny.pt.last").exists()
    assert train.main([str(cfg), "--resume"]) == 0  # already complete

    assert test.main([str(cfg)]) == 0
    out = np.load(tmp_path / "testing" / "fe_LJtiny.npz")
    for k in ("bar", "md", "nf", "emus"):
        assert np.isfinite(out[k]), k
    assert out["Q0"].shape == out["Q1"].shape == (500, 2)
    assert np.isfinite(out["x0"]).all() and np.isfinite(out["x1"]).all()
    assert "bar=" in capsys.readouterr().out

    assert fe.main([str(cfg), "testing"]) == 0
    rec = np.load(tmp_path / "testing" / "fe_LJtiny_testing.npz")
    assert np.isfinite(rec["logp_generated"]) and np.isfinite(rec["bar"])

    only = tmp_path / "extra" / "t.npy"
    assert sample_data.main([str(cfg), "10", "--seed", "3", "--test-only",
                             str(only)]) == 0
    assert np.load(only).shape == (10, 12)
    assert sample_data.main([]) == 2 and train.main([]) == 2
    assert test.main([]) == 2 and fe.main([str(cfg)]) == 2


def test_train_cli_and_fe_eval(tmp_path):
    """tests/test_config_apps.py's pipeline on the port: apps.train on
    Gaussian_rnvp.yaml (400 epochs, the CPU), its checkpoint, then fe_diff
    at 500 samples: bar near the exact 0 and the four estimators agree;
    the Q plot is written."""
    from normalizingflow_tpu_torch.apps.fe_eval import fe_diff
    from normalizingflow_tpu_torch.apps.test import load_trained
    from normalizingflow_tpu_torch.apps.train import main as train_main

    with open(os.path.join(ROOT, "configs", "Gaussian_rnvp.yaml")) as f:
        base = yaml.safe_load(f)
    base["device"] = "cpu"
    base["train_parameters"]["max_epochs"] = 400
    base["output"] = {k: str(tmp_path / d) + "/" for k, d in (
        ("training_dir", "train"), ("testing_dir", "test"),
        ("model_dir", "models"), ("best_model_dir", "best"))}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(base))

    assert train_main([str(cfg_path)]) == 0
    assert (tmp_path / "models" / "Gaussian_rnvp_2l.pt").exists()
    flow, potential, cfg = load_trained(tconfig.load_config(str(cfg_path)))
    out = fe_diff(flow, potential, 500, cfg.dataset.nparticles,
                  kT=cfg.dataset.kT, plot_path=str(tmp_path / "Q.png"),
                  generator=torch.Generator().manual_seed(5))
    assert abs(out["bar"]) < 0.5
    assert abs(out["bar"] - out["emus"]) < 0.1
    assert abs(out["bar"] - out["md"]) < 0.2
    assert abs(out["bar"] - out["nf"]) < 0.2
    assert (tmp_path / "Q.png").exists()


def test_sample_data_segmented_generation(monkeypatch):
    """200 frames at 16 chains are 13 draws: generate runs them as
    segments of 8 and 5 from the carried state and returns exactly
    (200, 96) finite frames, acceptance in (0.5, 1]."""
    from normalizingflow_tpu_torch.apps import sample_data

    segments = []
    real = sample_data.run_hmc

    def spy(*args, **kw):
        segments.append(kw["num_samples"])
        return real(*args, **kw)

    monkeypatch.setattr(sample_data, "run_hmc", spy)
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "Einstein.yaml"))
    frames, acc = sample_data.generate(cfg, nframes=200, chains=16, seed=3,
                                       device="cpu")
    assert segments == [8, 5]
    assert tuple(frames.shape) == (200, 96)
    assert bool(torch.isfinite(frames).all())
    assert 0.5 < acc <= 1.0
