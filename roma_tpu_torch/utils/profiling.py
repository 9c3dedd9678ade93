"""Tracing, timing and metric logging (counterpart of
roma_tpu/utils/profiling.py): a torch.profiler trace capture, named trace
ranges, a step-time and items/s meter with a warmup skip, and a JSON-lines
metric logger that writes on rank 0 only, with an optional wandb sink, in
place of the reference's hard-wired ``wandb.log(..., step=GLOBAL_STEP)``.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any

import torch

from ..parallel import dist


@contextlib.contextmanager
def trace(dir: str):
    """Capture a torch.profiler trace of the host and the card (when there is
    one) into ``dir``, viewable in TensorBoard or Perfetto."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(dir)):
        yield


def annotate(name: str):
    """A named range in traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Step-time / throughput meter with warmup skip: the first ``warmup``
    steps timed are left out of the means. The caller ends each timed step
    in a synchronize (or a value read back), or the host clock measures the
    enqueue."""

    def __init__(self, items_per_step: int = 1, warmup: int = 1):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: float | None = None
        self._steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self._times.append(dt)

    @property
    def times(self) -> list[float]:
        """The step times after the warmup, seconds."""
        return list(self._times)

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def items_per_sec(self) -> float:
        t = self.mean_step_time
        return self.items_per_step / t if t > 0 else 0.0


class MetricLogger:
    """JSON-lines metric logger; rank 0 only; optional wandb sink (used when
    the package imports)."""

    def __init__(self, use_wandb: bool = False, file: str | None = None):
        self.enabled = dist.rank() == 0
        self._file = open(file, "a") if (file and self.enabled) else None
        self._wandb = None
        if use_wandb and self.enabled:
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: dict[str, Any], step: int):
        if not self.enabled:
            return
        payload = {k: float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        line = json.dumps({"step": step, **payload})
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
