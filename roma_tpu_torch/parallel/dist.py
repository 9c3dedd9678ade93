"""Data parallelism on torch.distributed (counterpart of
roma_tpu/parallel/mesh.py and of the shard_map step of
roma_tpu/train/train.py:134-165; the reference's torchrun + DDP,
experiments/train_roma_outdoor.py:170,232).

RoMa's only parallelism is data parallelism over image pairs: one process a
card, the parameters replicated, each rank a slice of the batch. The
training step (train/train.py) averages the gradients over the ranks before
the clip and the update, and the BatchNorm running statistics, the loss and
the metrics after it, as the JAX step ``pmean``s them. Each rank's
BatchNorms normalize with its own slice's statistics, as one device's shard
does under shard_map (not SyncBN).

Every function here works without a process group, as one process: rank 0
of 1, no collective.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn as nn

BUCKET_ELEMS = 1 << 25  # elements a gradient all-reduce carries at once (128 MB of float32)


def init(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) and return this rank's
    device. The backend follows ``device``: ``nccl`` on the card, where each
    rank takes the card ``LOCAL_RANK`` (or its rank), ``gloo`` on the CPU.
    Asking for the card where there is none raises. A process already in a
    group stays in it and gets its device back (a second recipe built in
    one process)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"dist.init: no backend for device {device!r}; cuda (nccl) or cpu (gloo)")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dist.init: the card was asked for and none is available; "
                           "pass the device cpu for a gloo group on the CPU")
    if active():
        return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
            else torch.device("cpu")
    if kind == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local)
        return local
    dist.init_process_group("gloo")
    return torch.device("cpu")


def active() -> bool:
    """Whether a process group is up (the step then runs its collectives,
    at any world size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def barrier():
    if active():
        dist.barrier()


def shutdown():
    """Leave the process group, if one is up."""
    if active():
        dist.destroy_process_group()


def shard_batch(batch: dict) -> dict:
    """This rank's contiguous block of the leading axis of every array in a
    global ``batch``: rows [r * b, (r + 1) * b) with b = global / world size,
    the shard one device holds under the JAX package's ``P("data")``."""
    r, n = rank(), world_size()
    out = {}
    for k, v in batch.items():
        if len(v) % n:
            raise ValueError(f"shard_batch: {k} has {len(v)} rows, not a multiple of {n} ranks")
        b = len(v) // n
        out[k] = v[r * b:(r + 1) * b]
    return out


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Broadcast every parameter and buffer from rank 0, so that all ranks
    start from rank 0's state."""
    if active():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Average ``tensors`` over the ranks in place. Tensors of one dtype are
    flattened into buckets of up to BUCKET_ELEMS elements, one all-reduce a
    bucket."""
    if not active():
        return tensors
    n = world_size()
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        buckets, size = [[]], 0
        for t in group:
            if buckets[-1] and size + t.numel() > BUCKET_ELEMS:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel()
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat)
            flat /= n
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))
    return tensors


def bn_running_stats(module: nn.Module) -> list[torch.Tensor]:
    """The running means and variances of the BatchNorms in training mode
    under ``module`` (a frozen BatchNorm kept in eval mode, as XFeat's,
    does not move and is left out)."""
    return [b for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.training and m.track_running_stats
            for b in (m.running_mean, m.running_var)]
