from .analytic import (
    Banana,
    CorrelatedGaussian,
    IllConditionedGaussian,
    NealsFunnel,
)
from .base import PotentialTarget, Target

__all__ = [
    "Target", "PotentialTarget",
    "Banana", "CorrelatedGaussian", "IllConditionedGaussian", "NealsFunnel",
]
