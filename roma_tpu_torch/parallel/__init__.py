"""Data parallelism on torch.distributed (counterpart of roma_tpu/parallel)."""
from .dist import (
    active,
    all_reduce_mean_,
    barrier,
    bn_running_stats,
    init,
    rank,
    replicate,
    shard_batch,
    shutdown,
    world_size,
)

__all__ = ["active", "all_reduce_mean_", "barrier", "bn_running_stats", "init", "rank", "replicate",
           "shard_batch", "shutdown", "world_size"]
