from .mesh import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from .sharded import make_sharded_train_step, run_hmc_sharded, run_smc_sharded

__all__ = [
    "batch_sharding", "initialize_distributed", "make_mesh", "make_mesh_2d",
    "pad_to_multiple", "replicated", "shard_batch",
    "make_sharded_train_step", "run_hmc_sharded", "run_smc_sharded",
    "Mesh",
]
