"""lj500_nsf_tcl on the program: the flow `config.setup_model` builds for
flow type NSF_TCL (NormalizingFlow(EinsteinCrystal, Chain(
[TransformerCoupling] * layers)) through `build_flow_stack`) and its LJ
target, with the benchmark's weights and lattice copied in."""

from __future__ import annotations

import torch

from nfbench.ports import load_weights


def config(cfg, centers):
    """The program's Config of the configuration file `cfg`."""
    from normalizingflow_tpu_torch.config import (
        Config,
        DatasetConfig,
        FlowConfig,
        PriorConfig,
    )

    return Config(
        dataset=DatasetConfig(
            potential="LJ", nparticles=cfg["nparticles"], dim=cfg["dim"],
            kT=cfg["kT"], rho=cfg["rho"], cutoff=cfg["cutoff"], shift=True),
        flow=FlowConfig(
            type=cfg["flow_type"], nlayers=cfg["layers"],
            nsplines=cfg["nsplines"], embed_dim=cfg["embed_dim"],
            num_heads=cfg["num_heads"], num_blocks=cfg["num_blocks"],
            num_freqs=cfg["num_freqs"]),
        prior=PriorConfig(type=cfg["prior_type"], alpha=cfg["prior_alpha"],
                          centers=centers.tolist()))


def build(cfg, params, centers, device):
    """(flow, target) of the program, the flow holding `params`."""
    from normalizingflow_tpu_torch.config import setup_model

    flow, target, _ = setup_model(config(cfg, centers), device=device,
                                  dtype=torch.float32)
    load_weights(flow, params)
    return flow, target
