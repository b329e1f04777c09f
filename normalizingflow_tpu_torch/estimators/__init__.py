from .bar import bar, bar_zero
from .ess import (
    bulk_ess,
    bulk_ess_per_dim,
    effective_sample_size,
    ess_per_dim,
    min_ess,
    potential_scale_reduction,
    tail_ess,
)
from .mbar import mbar, mbar_from_q
from .zwanzig import zwanzig, zwanzig_forward

__all__ = [
    "bar", "bar_zero",
    "bulk_ess", "bulk_ess_per_dim", "effective_sample_size", "ess_per_dim",
    "min_ess", "potential_scale_reduction", "tail_ess",
    "mbar", "mbar_from_q",
    "zwanzig", "zwanzig_forward",
]
