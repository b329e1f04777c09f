from .analytic import (
    Banana,
    CorrelatedGaussian,
    IllConditionedGaussian,
    NealsFunnel,
)
from .base import PotentialTarget, Target
from .dataset import TrajectoryDataset, load_trajectory
from .lj import LennardJones, lj_pair_energy_total

__all__ = [
    "Target", "PotentialTarget",
    "Banana", "CorrelatedGaussian", "IllConditionedGaussian", "NealsFunnel",
    "TrajectoryDataset", "load_trajectory",
    "LennardJones", "lj_pair_energy_total",
]
