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
    hmc_kernel,
    hmc_kernel_batched,
    hmc_kernel_chainbatched,
    hmc_transition,
    leapfrog,
    padded_length,
    pointwise_lp_grad,
    run_hmc,
    transition_draws,
)
from .neutra import (
    NeutraResult,
    neutra_hmc,
    pullback_logprob,
    pullback_logprob_batched,
    push_to_data,
)
from .nuts import (
    NUTSInfo,
    NUTSResult,
    TransitionDraws,
    nuts_kernel,
    nuts_transition,
    run_nuts,
)
from .relaxation import (
    RelaxationResult,
    collect_hmc_data,
    integrate_out_v,
    metropolize,
    relaxation_step,
)
from .smc import (
    SMCResult,
    ess_from_log_weights,
    flow_smc,
    run_smc,
    systematic_resampling,
)

__all__ = [
    "DualAveragingState", "WelfordState", "da_init", "da_step_size",
    "da_update", "warmup_schedule", "welford_init", "welford_update_batch",
    "welford_variance",
    "HMCInfo", "HMCResult", "HMCState", "batched_lp_grad",
    "hmc_init", "hmc_kernel", "hmc_kernel_batched", "hmc_kernel_chainbatched",
    "hmc_transition", "leapfrog", "padded_length", "pointwise_lp_grad",
    "run_hmc", "transition_draws",
    "NUTSInfo", "NUTSResult", "TransitionDraws", "nuts_kernel",
    "nuts_transition", "run_nuts",
    "NeutraResult", "neutra_hmc", "pullback_logprob",
    "pullback_logprob_batched", "push_to_data",
    "RelaxationResult", "collect_hmc_data", "integrate_out_v", "metropolize",
    "relaxation_step",
    "SMCResult", "ess_from_log_weights", "flow_smc", "run_smc",
    "systematic_resampling",
]
