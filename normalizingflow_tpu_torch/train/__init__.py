from .loop import ClippedAdam, bench_optimizer, train, train_step
from .objectives import elbo, forward_kl, forward_kl_loss, reverse_kl

__all__ = [
    "ClippedAdam", "bench_optimizer", "train", "train_step",
    "elbo", "forward_kl", "forward_kl_loss", "reverse_kl",
]
