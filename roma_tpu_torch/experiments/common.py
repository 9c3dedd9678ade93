"""What the training entry points share (counterpart of the setup code
repeated in experiments/train_*.py): the resolutions and sample counts of
the recipe, the process group, MegaDepth's two overlap bands, an epoch's
loader over the weighted index stream, and its batches on the device.

Each entry module factors its recipe into ``build(args, config=None)``,
which returns a :class:`Recipe`, and ``run(args)``, the loop of epochs; a
test or a smoke run can drive the recipe's own objects for a few steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..datasets.loader import DataLoader, to_device, weighted_sample_indices
from ..datasets.megadepth import ConcatDataset, MegadepthBuilder
from ..parallel import dist
from ..train import CheckPoint, TrainState

RESOLUTIONS = {"low": (448, 448), "medium": (560, 560), "high": (672, 672)}
K_SAMPLES = 25_000  # samples an epoch: between two checkpoints (experiments/train_roma_outdoor.py:56)


@dataclasses.dataclass
class Recipe:
    """The objects of one training run. ``step``, ``dataset`` and
    ``weights`` are one stream's; the indoor recipe holds a dict of each,
    keyed by stream ("mega", "scannet"). ``batch_size`` is one rank's."""

    state: TrainState
    step: Any
    dataset: Any
    weights: Any
    checkpointer: CheckPoint
    device: torch.device
    hw: tuple[int, int]
    batch_size: int
    n_steps: int


def add_common_flags(p: argparse.ArgumentParser):
    """The flags every recipe takes, with the JAX scripts' defaults, and
    ``--device`` (the port's entry points run on the card unless asked)."""
    p.add_argument("--ckpt_dir", default="workspace/checkpoints")
    p.add_argument("--gpu_batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--bf16", action="store_true", default=True, help="bf16 autocast over float32 parameters")
    p.add_argument("--distributed", action="store_true",
                   help="one process a card under torchrun; nccl on the card, gloo with --device cpu")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; under --distributed it picks the backend")


def setup(args) -> torch.device:
    """This process's device, ``--device``; under ``--distributed`` the
    process group's, on the backend that device takes (dist.init)."""
    return dist.init(args.device) if args.distributed else torch.device(args.device)


def megadepth_bands(data_root: str, h: int, w: int, **kw) -> tuple[ConcatDataset, np.ndarray]:
    """The recipe's two overlap bands of MegaDepth's ``train_loftr`` scenes,
    0.01-1 and 0.35-0.9 (experiments/train_roma_outdoor.py:82-88), as one
    dataset, and its 1/n^0.75 scene weights. Each scene's randomized size
    follows the rank."""
    mega = MegadepthBuilder(data_root=data_root, loftr_ignore=True, imc21_ignore=True)
    common = dict(ht=h, wt=w, rank=dist.rank(), **kw)
    scenes = mega.build_scenes(split="train_loftr", min_overlap=0.01, **common)
    scenes += mega.build_scenes(split="train_loftr", min_overlap=0.35, max_overlap=0.9, **common)
    dataset = ConcatDataset(scenes)
    return dataset, MegadepthBuilder.weight_scenes(dataset, alpha=0.75)


def epoch_loader(dataset, weights, batch_size: int, host_rng: np.random.RandomState,
                 num_workers: int) -> DataLoader:
    """An epoch's loader: K_SAMPLES draws (or the whole dataset) by weight
    without replacement, this rank's slice of them. ``host_rng`` is seeded
    alike on every rank, so the ranks' slices are disjoint."""
    idxs = weighted_sample_indices(host_rng, weights, min(K_SAMPLES, len(dataset)))
    return DataLoader(dataset, idxs, batch_size, num_workers=num_workers,
                      rank=dist.rank(), world_size=dist.world_size())


class DeviceBatches:
    """The loader's batches on ``device``; ``waits`` holds the host's time
    spent waiting on the loader for each batch, seconds."""

    def __init__(self, loader, device):
        self.loader, self.device = loader, device
        self.waits: list[float] = []

    def __iter__(self) -> Iterator[dict]:
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield to_device(batch, self.device)
        finally:
            it.close()  # a consumer that stops early stops the loader's threads


def progress(log_every: int, extra: tuple[str, ...] = ("grad_norm",)) -> Callable:
    """A train_k_steps progress callback: rank 0 prints the loss (and
    ``extra``) every ``log_every`` steps."""

    def show(s, m):
        if s % log_every == 0 and dist.rank() == 0:
            print(f"step {s}: loss={float(m['loss']):.4f} "
                  + " ".join(f"{k}={float(m[k]):.4f}" for k in extra), flush=True)

    return show
