"""Data parallelism on torch.distributed, and the device list of one process
(counterpart of roma_tpu/parallel)."""
from .devices import get_devices
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

__all__ = ["active", "all_reduce_mean_", "barrier", "bn_running_stats", "get_devices", "init", "rank", "replicate",
           "shard_batch", "shutdown", "world_size"]
