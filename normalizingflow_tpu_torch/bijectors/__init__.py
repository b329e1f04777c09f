from .base import Bijector, Chain, Invert
from .coupling import AffineCoupling
from .elementary import ActNorm
from .mlp import MLP

__all__ = ["Bijector", "Chain", "Invert", "AffineCoupling", "ActNorm", "MLP"]
