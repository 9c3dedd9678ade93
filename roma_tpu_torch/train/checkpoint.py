"""Checkpoint and resume (counterpart of roma_tpu/train/checkpoint.py;
reference romatch/checkpointing/checkpoint.py:10-60).

``torch.save`` of {net state dict (parameters and BatchNorm buffers),
optimizer state, step, EMA} to ``<dir>/<name>/step_<n>.pt``, keeping the two
newest. ``load`` restores the newest into a state in place; a missing
checkpoint leaves the state as it is, and an optimizer state that does not
fit the optimizer is skipped, as the JAX package tolerates a partial restore.
A restored state goes on exactly where it stopped: the step, the
optimizer's update count (so the learning-rate schedule), AdamW's moments
and the EMA with its ramp (train_k_steps counts EMA updates from the step).

Under a process group rank 0 writes, every rank waits at a barrier, then
each rank reads the file onto its own device.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from ..parallel import dist
from .train import TrainState


class CheckPoint:
    MAX_TO_KEEP = 2

    def __init__(self, dir: str, name: str = "model"):
        self.dir = Path(dir).resolve() / name
        self.dir.mkdir(parents=True, exist_ok=True)

    def _files(self) -> list[Path]:
        return sorted(self.dir.glob("step_*.pt"), key=lambda f: int(f.stem.split("_")[1]))

    def save(self, state: TrainState) -> Path:
        path = self.dir / f"step_{state.step}.pt"
        if dist.rank() == 0:
            tmp = path.with_suffix(".tmp")
            torch.save({
                "net": state.net.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step,
                "ema_params": state.ema_params,
            }, tmp)
            os.replace(tmp, path)  # a reader never sees a partial file
            for old in self._files()[:-self.MAX_TO_KEEP]:
                old.unlink()
        dist.barrier()
        return path

    def load(self, state: TrainState) -> TrainState:
        files = self._files()
        if not files:
            return state
        dev = next(state.net.parameters()).device
        payload = torch.load(files[-1], map_location=dev, weights_only=True)
        state.net.load_state_dict(payload["net"])
        try:
            state.optimizer.load_state_dict(payload["optimizer"])
        except (ValueError, KeyError) as err:
            print(f"CheckPoint: optimizer state not restored ({err})")
        state.step = int(payload["step"])
        state.ema_params = payload["ema_params"]
        return state
