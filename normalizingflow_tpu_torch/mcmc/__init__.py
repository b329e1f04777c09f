from .adaptation import (
    DualAveragingState,
    WelfordState,
    da_init,
    da_step_size,
    da_update,
    warmup_schedule,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .hmc import (
    HMCInfo,
    HMCResult,
    HMCState,
    batched_lp_grad,
    hmc_init,
    hmc_transition,
    leapfrog,
    padded_length,
    run_hmc,
    transition_draws,
)
from .neutra import (
    NeutraResult,
    neutra_hmc,
    pullback_logprob_batched,
    push_to_data,
)
from .relaxation import (
    RelaxationResult,
    collect_hmc_data,
    integrate_out_v,
    metropolize,
    relaxation_step,
)

__all__ = [
    "DualAveragingState", "WelfordState", "da_init", "da_step_size",
    "da_update", "warmup_schedule", "welford_init", "welford_update_batch",
    "welford_variance",
    "HMCInfo", "HMCResult", "HMCState", "batched_lp_grad", "hmc_init",
    "hmc_transition", "leapfrog", "padded_length", "run_hmc",
    "transition_draws",
    "NeutraResult", "neutra_hmc", "pullback_logprob_batched", "push_to_data",
    "RelaxationResult", "collect_hmc_data", "integrate_out_v", "metropolize",
    "relaxation_step",
]
