"""Experiment configuration: the YAML schema and the registry factories.
Twin of normalizingflow_tpu/config.py.

  * the schema dataclasses and their defaults are the JAX package's, so
    every file in configs/ parses to the same values; unknown keys raise,
    and yacs-style "1e-4" strings become floats; FlowConfig adds NSF_TCL's
    fields (PORT_ONLY_FLOW_FIELDS), which no JAX config sets;
  * box-length inference: B = (N/(8 rho))^(1/3) from the density, or
    B = ncellx * cell_len / 2 from the cell grid; boxlength = 2B, and the
    spline tail bound is B;
  * the NSF_CL coordinate-mask cycle [[0],[1],[2],[0,1],[1,2],[0,2]], and
    the Repeat/Chain switch of RealNVP and NSF_AR, which fixes the params
    tree's structure, exactly as in JAX;
  * NSF_TCL, the port's alone: transformer-conditioned circular-spline
    couplings (bijectors/transformer.py), layer l moving axis l mod dim,
    in the box of side boxlength;
  * the `device:` key: `cpu` runs on the CPU; `tpu`, `cuda`, `cuda:N` or no
    key mean the card (the configs name the accelerator they were written
    for). Nothing falls back to the CPU: without a card, `cuda` raises.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import yaml

from .bijectors import (
    ActNorm,
    AffineCoupling,
    Chain,
    InvertibleLinear,
    MaskedAffineAR,
    Planar,
    Radial,
    Repeat,
    SplineAR,
    SplineCoupling,
    TransformerCoupling,
)
from .device import entry_device
from .distributions import DiagNormal, EinsteinCrystal, GaussianMixture
from .flow import NormalizingFlow
from .targets import (
    EAMIron,
    GaussianField,
    LennardJones,
    Phi4Lattice,
    TrajectoryDataset,
)


# --------------------------------------------------------------- schema
@dataclass
class DatasetConfig:
    name: Optional[str] = None
    potential: Optional[str] = None
    training_data: Optional[str] = None
    testing_data: Optional[str] = None
    data: Optional[str] = None
    nparticles: int = 32
    dim: int = 3
    kT: float = 1.0
    rho: Optional[float] = None
    ncellx: Optional[int] = None
    ncelly: Optional[int] = None
    ncellz: Optional[int] = None
    cell_len: Optional[float] = None
    boxlength: Optional[float] = None
    periodic: bool = True
    type: str = "xyz"
    # LJ
    sigma: float = 1.0
    epsilon: float = 1.0
    cutoff: Optional[float] = 1.6
    shift: bool = True
    # GaussianMixture / EinsteinCrystal
    centers: Any = None
    vars: Any = None
    alpha: Optional[float] = None
    # Fe / phi4
    input_dir: Optional[str] = None
    L: int = 8
    kappa: float = 0.3
    lam: float = 0.022
    # GaussianField (polymer-surrogate GFF)
    channels: int = 2
    mass: Any = None


@dataclass
class FlowConfig:
    type: str = "NSF_AR"
    nlayers: int = 3
    nsplines: int = 32
    hidden_dim: int = 100
    periodic: bool = True
    s_cap: Optional[float] = None   # RealNVP log-scale soft clamp
    zero_init: bool = False         # RealNVP identity init
    # NSF_TCL (the port's own; the JAX schema has no such flow): the
    # transformer's width, heads, blocks and Fourier frequencies
    # (PORT_ONLY_FLOW_FIELDS)
    embed_dim: int = 256
    num_heads: int = 2
    num_blocks: int = 2
    num_freqs: int = 8


# FlowConfig's fields the JAX schema lacks: a config written for the JAX
# package leaves them at their defaults
PORT_ONLY_FLOW_FIELDS = ("embed_dim", "num_heads", "num_blocks", "num_freqs")


@dataclass
class PriorConfig:
    type: Optional[str] = None
    lattice_dir: Optional[str] = None
    alpha: float = 100.0
    centers: Any = None
    vars: Any = None
    nparticles: Optional[int] = None
    dim: Optional[int] = None
    boxlength: Optional[float] = None


@dataclass
class TrainConfig:
    max_epochs: int = 4000
    batch_size: int = 100
    output_freq: int = 100
    learning_rate: float = 1e-4
    scheduler: str = "exponential"
    lr_scheduler_gamma: float = 0.999
    # acceptance-gated HMC data mixing
    hmc_mix: bool = False
    hmc_mix_step_size: float = 0.01
    hmc_mix_leapfrog: int = 10
    hmc_mix_chains: int = 8
    # reverse-KL fine-tune after the forward-KL fit; 0 = off
    rkl_finetune_steps: int = 0
    rkl_finetune_lr: float = 1e-4
    rkl_finetune_batch: int = 256


@dataclass
class OutputConfig:
    training_dir: str = "training/"
    testing_dir: str = "testing/"
    model_dir: str = "saved_models/"
    best_model_dir: str = "trained_models/"


@dataclass
class Config:
    device: str = "tpu"
    seed: int = 0
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    train_parameters: TrainConfig = field(default_factory=TrainConfig)
    output: OutputConfig = field(default_factory=OutputConfig)


def _merge_dataclass(dc, overrides):
    if not overrides:
        return dc
    names = {f.name for f in dataclasses.fields(dc)}
    updates = {}
    for k, v in overrides.items():
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur):
            updates[k] = _merge_dataclass(cur, v)
        elif isinstance(v, str) and isinstance(cur, float):
            updates[k] = float(v)  # yacs-style "1e-4" strings
        else:
            updates[k] = v
    return dataclasses.replace(dc, **updates)


def load_config(path):
    """Parse a reference-format YAML file into a Config."""
    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    return _merge_dataclass(Config(), raw)


def jax_schema(cfg):
    """`dataclasses.asdict(cfg)` as the JAX package's schema has it: the
    port-only flow fields (PORT_ONLY_FLOW_FIELDS) left out. Raises where
    one of them is not at its default, which no JAX config could state."""
    d = dataclasses.asdict(cfg)
    flow = dict(d["flow"])
    for name in PORT_ONLY_FLOW_FIELDS:
        if flow.pop(name) != getattr(FlowConfig, name):
            raise ValueError(f"flow.{name} is set; the JAX schema has no "
                             f"such field")
    return dict(d, flow=flow)


def config_device(cfg):
    """The torch device a config runs on: `device: cpu` is the CPU, any
    other value (tpu, cuda, cuda:N) or none the card."""
    name = str(cfg.device or "").lower()
    if name == "cpu":
        return entry_device("cpu")
    return entry_device(name if name.startswith("cuda") else "cuda")


# ------------------------------------------------------------ box length
def infer_boxlength(ds: DatasetConfig):
    """Half-box B and full boxlength 2B."""
    if ds.boxlength is not None and ds.boxlength > 0:
        return ds.boxlength / 2.0, ds.boxlength
    if ds.rho is not None:
        b = (ds.nparticles / (8.0 * ds.rho)) ** (1.0 / 3.0)
    elif ds.ncellx is not None and ds.cell_len is not None:
        b = ds.ncellx * ds.cell_len / 2.0
    else:
        b = 1.0
    return b, 2.0 * b


# -------------------------------------------------------------- registries
def _load_centers(centers, point_dim):
    """Literal lists, or the path of an .xyz lattice."""
    if isinstance(centers, str):
        from .io.xyz import read_xyz

        return read_xyz(centers).reshape(-1, point_dim)
    return centers


def build_potential(name, cfg_section, ds: DatasetConfig, boxlength=None,
                    device=None, dtype=None):
    """The prior or target named `name`, from its config section."""
    c = cfg_section
    kw = dict(device=device, dtype=dtype)
    data = ds.data if ds.data and os.path.exists(ds.data) else None
    if name in ("GaussianMixture", "gaussian_mix"):
        return GaussianMixture(
            _load_centers(c.centers, ds.dim), c.vars,
            npoints=getattr(c, "nparticles", None) or ds.nparticles,
            point_dim=ds.dim, **kw)
    if name == "EinsteinCrystal":
        return EinsteinCrystal(
            _load_centers(c.centers, ds.dim),
            alpha=c.alpha if c.alpha is not None else 50.0,
            boxlength=getattr(c, "boxlength", None) or boxlength,
            point_dim=ds.dim, **kw)
    if name == "Normal":
        n = (getattr(c, "nparticles", None) or ds.nparticles) * (
            getattr(c, "dim", None) or ds.dim)
        var = c.vars if c.vars is not None else 1.0
        return DiagNormal(n, var=float(var), **kw)
    if name == "LJ":
        return LennardJones(
            ds.nparticles, boxlength, point_dim=ds.dim, epsilon=ds.epsilon,
            sigma=ds.sigma, cutoff=ds.cutoff, shift=ds.shift, kT=ds.kT,
            pos_dir=data, data_type=ds.type, **kw)
    if name == "SimData":
        return TrajectoryDataset(ds.data, data_type=ds.type, **kw)
    if name == "Fe":
        # dataset.input_dir names the EAM setfl table (the reference's
        # LAMMPS potential file); without it, the analytic Finnis-Sinclair
        # model
        setfl = ds.input_dir
        if setfl and not os.path.exists(setfl):
            raise FileNotFoundError(
                f"dataset.input_dir={setfl!r} (EAM setfl table) not found")
        return EAMIron(ds.nparticles, boxlength=boxlength, kT=ds.kT,
                       setfl_path=setfl or None, pos_dir=data,
                       data_type=ds.type, **kw)
    if name == "Phi4":
        return Phi4Lattice(L=ds.L, kappa=ds.kappa, lam=ds.lam, pos_dir=data,
                           data_type=ds.type, **kw)
    if name == "GaussianField":
        return GaussianField(
            L=ds.L, channels=ds.channels,
            mass=ds.mass if ds.mass is not None else (0.5, 1.0), **kw)
    raise KeyError(f"unknown potential {name!r}")


_NSF_CL_MASK_CYCLE = [[0], [1], [2], [0, 1], [1, 2], [0, 2]]


def build_flow_stack(cfg: Config, b: float, device=None, dtype=None,
                     generator=None):
    """The flow's bijector stack. As in JAX, RealNVP at nlayers >= 4 with
    fewer than 2e8 estimated params, and NSF_AR at nlayers >= 4, become a
    Repeat (stacked params tree); everything else a Chain."""
    fc = cfg.flow
    n = cfg.dataset.nparticles * cfg.dataset.dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    if fc.type == "RealNVP":
        half = n // 2
        est_params = fc.nlayers * 4 * (
            2 * half * fc.hidden_dim + fc.hidden_dim ** 2)
        layers = [AffineCoupling(n, hidden_dim=fc.hidden_dim, s_cap=fc.s_cap,
                                 zero_init=fc.zero_init, **kw)
                  for _ in range(fc.nlayers)]
        if fc.nlayers >= 4 and est_params < 2e8:
            return Repeat(layers)
    elif fc.type == "NSF_AR":
        layers = [SplineAR(n, num_bins=fc.nsplines, tail_bound=b,
                           hidden_dim=fc.hidden_dim, periodic=fc.periodic,
                           **kw)
                  for _ in range(fc.nlayers)]
        if fc.nlayers >= 4:
            return Repeat(layers)
    elif fc.type == "NSF_CL":
        layers = [
            SplineCoupling(
                size=cfg.dataset.nparticles, space_dim=cfg.dataset.dim,
                num_bins=fc.nsplines, tail_bound=b, hidden_dim=fc.hidden_dim,
                mask=_NSF_CL_MASK_CYCLE[i % len(_NSF_CL_MASK_CYCLE)], **kw)
            for i in range(fc.nlayers)]
    elif fc.type == "NSF_TCL":
        layers = [
            TransformerCoupling(
                cfg.dataset.nparticles, 2.0 * b, axis=i % cfg.dataset.dim,
                num_bins=fc.nsplines, embed_dim=fc.embed_dim,
                num_heads=fc.num_heads, num_blocks=fc.num_blocks,
                num_freqs=fc.num_freqs, space_dim=cfg.dataset.dim, **kw)
            for i in range(fc.nlayers)]
    elif fc.type == "MAF":
        layers = [MaskedAffineAR(n, hidden_dim=fc.hidden_dim, **kw)
                  for _ in range(fc.nlayers)]
    elif fc.type == "Planar":
        layers = [Planar(n, **kw) for _ in range(fc.nlayers)]
    elif fc.type == "Radial":
        layers = [Radial(n, **kw) for _ in range(fc.nlayers)]
    elif fc.type == "ActNorm":
        layers = [ActNorm(n, device=device, dtype=dtype)
                  for _ in range(fc.nlayers)]
    elif fc.type == "OneByOneConv":
        layers = [InvertibleLinear(n, **kw) for _ in range(fc.nlayers)]
    else:
        raise KeyError(f"unknown flow type {cfg.flow.type!r}")
    return Chain(layers)


def setup_model(cfg: Config, mode="training", device=None,
                dtype=torch.float32, generator=None):
    """(flow, data potential, cfg with the boxlength filled in).

    `device` defaults to the config's (`config_device`); the flow's initial
    weights come from `generator` (on that device), or torch's default
    generator. `mode` picks the training or testing data path."""
    device = config_device(cfg) if device is None else entry_device(device)
    b, boxlength = infer_boxlength(cfg.dataset)
    if cfg.dataset.boxlength is None:
        cfg = dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, boxlength=boxlength))
    kw = dict(device=device, dtype=dtype)
    prior = build_potential(cfg.prior.type, cfg.prior, cfg.dataset,
                            boxlength=boxlength, **kw)
    flow = NormalizingFlow(prior, build_flow_stack(cfg, b,
                                                   generator=generator, **kw))
    ds = cfg.dataset
    data_path = ds.training_data if mode == "training" else ds.testing_data
    if data_path is not None:
        ds = dataclasses.replace(ds, data=data_path)
    potential = build_potential(ds.potential, ds, ds, boxlength=boxlength,
                                **kw)
    return flow, potential, cfg
