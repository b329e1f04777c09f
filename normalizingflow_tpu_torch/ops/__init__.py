"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Kernels are compiled from ../csrc at first use (see _build.py); importing
this package compiles and loads nothing.
"""

# The kernels' wrappers, each counting its own launches (`fn.launches`).
LAUNCH_KEYS = ("accept_select", "accept_unfused", "rqs", "rqs_vjp")


def _wrappers():
    from .hmc import accept_select, accept_select_fused
    from .rqs import rqs_cuda, rqs_vjp_cuda

    return dict(zip(LAUNCH_KEYS, (accept_select_fused, accept_select,
                                  rqs_cuda, rqs_vjp_cuda)))


def launch_counts():
    """The launch counters of the kernels' wrappers in this process."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts():
    """Set every wrapper's launch counter to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
