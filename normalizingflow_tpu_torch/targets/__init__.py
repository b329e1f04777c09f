from .analytic import (
    Banana,
    CorrelatedGaussian,
    IllConditionedGaussian,
    NealsFunnel,
)
from .base import PotentialTarget, Target
from .dataset import TrajectoryDataset, load_trajectory
from .eam import EAMIron, fs_iron_energy, load_setfl, tabulated_eam_energy
from .gff import GaussianField, gff_action
from .lj import LennardJones, lj_pair_energy_total
from .phi4 import Phi4Lattice, phi4_action

__all__ = [
    "Target", "PotentialTarget",
    "Banana", "CorrelatedGaussian", "IllConditionedGaussian", "NealsFunnel",
    "TrajectoryDataset", "load_trajectory",
    "EAMIron", "fs_iron_energy", "load_setfl", "tabulated_eam_energy",
    "GaussianField", "gff_action",
    "LennardJones", "lj_pair_energy_total",
    "Phi4Lattice", "phi4_action",
]
