from .ess import (
    bulk_ess,
    bulk_ess_per_dim,
    effective_sample_size,
    ess_per_dim,
    min_ess,
    potential_scale_reduction,
    tail_ess,
)

__all__ = [
    "bulk_ess", "bulk_ess_per_dim", "effective_sample_size", "ess_per_dim",
    "min_ess", "potential_scale_reduction", "tail_ess",
]
