"""Host-side batching and prefetch (counterpart of roma_tpu/datasets/loader.py;
in place of the reference's torch DataLoader(num_workers=8) +
WeightedRandomSampler, experiments/train_roma_outdoor.py:236-246).

A thread pool decodes (PIL and h5py release the GIL) and a small queue keeps
batches ready while the card runs a step. Each rank takes the slice
``indices[rank::world_size]`` of one index stream that every rank draws from
the same seed. :func:`to_device` moves a numpy batch to the card through
the one staging helper (``utils.staging``).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from ..utils.profiling import annotate
from ..utils.staging import PinnedStaging

BATCH_KEYS = ("im_A", "im_B", "im_A_depth", "im_B_depth", "K1", "K2", "T_1to2")
_STAGING = PinnedStaging()  # to_device's: one pinned buffer for the process


def weighted_sample_indices(
    rng: np.random.RandomState, weights: np.ndarray, num_samples: int
) -> np.ndarray:
    """WeightedRandomSampler(replacement=False) by Gumbel top-k on the host."""
    g = rng.gumbel(size=len(weights))
    scores = np.log(np.maximum(weights, 1e-30)) + g
    return np.argpartition(-scores, num_samples - 1)[:num_samples]


class DataLoader:
    """Iterates stacked-numpy batches with background prefetch.

    Args:
      dataset: indexable returning per-pair dicts.
      indices: epoch order (e.g. from weighted_sample_indices).
      batch_size: the batch of one rank.
      num_workers: decode threads.
      prefetch: batches queued ahead.
      rank/world_size: this rank's slice of the index stream.
    """

    def __init__(
        self,
        dataset,
        indices,
        batch_size: int,
        num_workers: int = 8,
        prefetch: int = 2,
        rank: int = 0,
        world_size: int = 1,
        keys=BATCH_KEYS,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)[rank::world_size]
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.keys = keys

    def __len__(self):
        return len(self.indices) // self.batch_size

    def _make_batch(self, pool, idx_chunk):
        items = list(pool.map(self.dataset.__getitem__, idx_chunk))
        return {k: np.stack([np.asarray(it[k]) for it in items]) for k in self.keys}

    def __iter__(self) -> Iterator[dict]:
        """Batches in index order. A decode error is raised here after the
        batches before it; a consumer that stops early (``break``, or the
        generator closed) stops the producer and its threads."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closing = threading.Event()
        failed: list[Exception] = []

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in range(len(self)):
                        if closing.is_set():
                            return
                        chunk = self.indices[start * self.batch_size : (start + 1) * self.batch_size]
                        q.put(self._make_batch(pool, chunk))
            except Exception as err:  # handed to the consumer, which raises it
                failed.append(err)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (item := q.get()) is not stop:
                yield item
        finally:
            closing.set()
            while t.is_alive():  # a producer blocked on a full queue gets room
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if failed:
            raise failed[0]


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``, through the process's one
    :class:`~roma_tpu_torch.utils.staging.PinnedStaging` (on a CUDA device
    one asynchronous copy from a reused pinned buffer, ordered before any
    kernel that reads it). Span: ``roma.loader.to_device``."""
    with annotate("roma.loader.to_device"):
        return dict(zip(batch, _STAGING.to_device(list(batch.values()), device)))
