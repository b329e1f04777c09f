from .checkpoint import (
    copy_checkpoint,
    load_checkpoint,
    load_jax_checkpoint,
    read_jax_checkpoint,
    save_checkpoint,
)
from .fused import train_flow_fused
from .loop import (
    Adam,
    ClippedAdam,
    bench_optimizer,
    make_optimizer,
    train,
    train_step,
)
from .objectives import (
    elbo,
    forward_kl,
    forward_kl_loss,
    reverse_kl,
    rkl_finetune,
)

__all__ = [
    "copy_checkpoint", "load_checkpoint", "load_jax_checkpoint",
    "read_jax_checkpoint", "save_checkpoint",
    "train_flow_fused",
    "Adam", "ClippedAdam", "bench_optimizer", "make_optimizer", "train",
    "train_step",
    "elbo", "forward_kl", "forward_kl_loss", "reverse_kl", "rkl_finetune",
]
