from .autoregressive import MaskedAffineAR, SplineAR
from .base import Bijector, Chain, Invert, Repeat
from .coupling import AffineCoupling, SplineCoupling
from .elementary import ActNorm, InvertibleLinear, Planar, Radial
from .mlp import MLP

__all__ = ["Bijector", "Chain", "Invert", "Repeat", "AffineCoupling",
           "SplineCoupling", "SplineAR", "MaskedAffineAR", "ActNorm", "Planar",
           "Radial", "InvertibleLinear", "MLP"]
