from .autoregressive import MaskedAffineAR, SplineAR
from .base import Bijector, Chain, Invert, Repeat
from .coupling import AffineCoupling, SplineCoupling
from .elementary import ActNorm, InvertibleLinear, Planar, Radial
from .mlp import MLP, mlp_apply, mlp_init
from .rqs import (
    circular_rqs,
    rational_quadratic_spline,
    split_spline_params,
    unconstrained_rqs,
)
from .transformer import TransformerCoupling

__all__ = ["Bijector", "Chain", "Invert", "Repeat", "AffineCoupling",
           "SplineCoupling", "SplineAR", "MaskedAffineAR", "ActNorm", "Planar",
           "Radial", "InvertibleLinear", "MLP", "mlp_apply", "mlp_init",
           "rational_quadratic_spline", "split_spline_params",
           "unconstrained_rqs", "circular_rqs", "TransformerCoupling"]
