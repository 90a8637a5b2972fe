from alphazero_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    barrier,
    broadcast_int,
    collective_device,
    make_mesh,
    replicate,
    shard_batch,
    sharded_selfplay_move,
    sharded_train_step,
)

__all__ = [
    "Mesh", "all_reduce_mean_", "barrier", "broadcast_int", "collective_device", "make_mesh",
    "replicate", "shard_batch", "sharded_selfplay_move",
    "sharded_train_step",
]
