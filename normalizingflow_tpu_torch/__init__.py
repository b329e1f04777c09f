"""PyTorch/CUDA port of normalizingflow_tpu for NVIDIA Hopper (H100).

The JAX package `normalizingflow_tpu` is the reference this port is held
against; every module here has a twin of the same path there. This package
imports `torch`, never `jax` and nothing of `normalizingflow_tpu`.

Conventions of the port:
  * bijectors, the flow, priors and targets are `nn.Module`s that own their
    parameters; everything else is a plain function on tensors;
  * randomness comes from an explicit `torch.Generator` (never the global
    RNG), or is passed in as tensors so a run can be replayed exactly;
  * entry points (`train.loop.train`, `mcmc.run_hmc`, `mcmc.neutra_hmc`)
    default to `device="cuda"` and raise on a host without a GPU;
  * each kernel that the JAX package wrote in Pallas is a hand-written CUDA
    kernel under `csrc/`, built with nvcc at first use (`ops/_build.py`).
"""

from . import bijectors, distributions
from .flow import NormalizingFlow

__version__ = "0.1.0"

__all__ = ["bijectors", "distributions", "NormalizingFlow", "__version__"]
