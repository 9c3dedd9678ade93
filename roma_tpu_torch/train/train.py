"""Training step and loop (counterpart of roma_tpu/train/train.py;
reference romatch/train/train.py:23-64).

PyTorch idiom in place of the JAX package's pure step: the module holds the
parameters and BatchNorm running stats, the optimizer its own state, and a
step updates both in place. bf16 compute comes from ``torch.autocast``
around the forward, over float32 master parameters; the loss runs in
float32 outside it.

Data parallelism (parallel/dist.py): under a process group the step does
what the JAX step does under a mesh (train.py:134-140): the gradients are
averaged over the ranks before the gradient statistics and the optimizer,
the BatchNorm running statistics after the update, and the loss and
metrics with them. Each rank's forward normalizes with its own batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch
import torch.nn as nn

from ..parallel import dist
from ..utils.profiling import annotate
from .optim import RoMaOptimizer, in_encoder


@dataclasses.dataclass
class TrainState:
    net: nn.Module
    optimizer: RoMaOptimizer
    step: int = 0
    ema_params: dict[str, torch.Tensor] | None = None  # float32 EMA by parameter name


def grad_statistics(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> dict:
    """Gradient statistics and non-finite detection (the reference's
    ``log_param_statistics``, train/train.py:7-21), on the device.

    ``params``: every parameter by name; ``grads``: the gradients by name.
    Returns ``grad_norm`` and ``param_norm``, ``grad_norm_encoder`` and
    ``grad_norm_decoder`` (non-finite leaves left out of the norms),
    ``nonfinite_grads`` (count of leaves with a non-finite gradient) and
    ``grad_finite_mask`` (one entry per leaf, in ``grads`` order: map it back
    with :func:`nonfinite_grad_names`)."""
    names = list(grads)
    leaf = torch.stack([torch.linalg.vector_norm(grads[k].float()) for k in names])
    finite = torch.isfinite(leaf)
    safe = torch.where(finite, leaf, torch.zeros_like(leaf))
    enc = torch.tensor([in_encoder(k) for k in names], device=leaf.device)
    group = lambda m: torch.linalg.vector_norm(torch.where(m, safe, torch.zeros_like(safe)))
    return {
        "grad_norm": torch.linalg.vector_norm(safe),
        "param_norm": torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.detach().float()) for p in params.values()])),
        "grad_norm_encoder": group(enc),
        "grad_norm_decoder": group(~enc),
        "nonfinite_grads": (~finite).sum().float(),
        "grad_finite_mask": finite.float(),
    }


def nonfinite_grad_names(names: Iterable[str], grad_finite_mask: torch.Tensor) -> list[str]:
    """Map a ``grad_finite_mask`` metric back to parameter names."""
    return [k for k, ok in zip(names, grad_finite_mask.tolist()) if ok < 1.0]


def ema_decay_schedule(decay: float, step: int) -> float:
    """Warmup-ramped EMA decay ``min(decay, (1+t)/(10+t))``: the first
    updates track the parameters almost exactly, so the EMA sheds the random
    initialization (see roma_tpu/train/train.py:ema_decay_schedule)."""
    return min(decay, (1.0 + step) / (10.0 + step))


def make_ema_update(decay: float, warmup: bool = True):
    """``update(ema, params, step)``, moving the float32 ``ema`` dict in
    place toward ``params`` (by name); ``step`` is the 0-based count of EMA
    updates already applied."""

    @torch.no_grad()
    def update(ema: dict, params: dict, step: int) -> dict:
        d = ema_decay_schedule(decay, step) if warmup else decay
        keys = list(ema)
        torch._foreach_lerp_([ema[k] for k in keys], [params[k].detach().float() for k in keys], 1.0 - d)
        return ema

    return update


def make_train_step(
    net: nn.Module,
    objective: Callable,
    optimizer: RoMaOptimizer,
    forward: Callable | None = None,
    amp_dtype: torch.dtype | None = None,
):
    """``step(batch) -> metrics``: forward (under ``torch.autocast`` when
    ``amp_dtype`` is set), ``objective(corresps, batch) -> (loss, metrics)``
    in float32, backward, gradient statistics, optimizer update. ``forward``
    defaults to ``net(batch["im_A"], batch["im_B"])``. The metrics are
    tensors on the device: reading one waits for the step. Under a process
    group, ``batch`` is this rank's slice and the collectives of the
    module's docstring run (at any world size, one rank included).

    Spans (``utils.profiling``): ``roma.train.step``; inside it
    ``roma.train.forward`` (forward and objective), ``roma.train.backward``
    and ``roma.train.optimizer`` (all-reduce, gradient statistics, AdamW),
    each with its device time."""
    if forward is None:
        def forward(net, batch):
            return net(batch["im_A"], batch["im_B"])

    params = dict(net.named_parameters())
    trainable = {k: p for k, p in params.items() if p.requires_grad}

    def update(loss, metrics) -> dict:
        if dist.active():
            # the graph is the same on every rank, so is the list of
            # gradients; a parameter none reached stays out of the update,
            # as on one process
            dist.all_reduce_mean_([p.grad for p in trainable.values() if p.grad is not None])
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in trainable.items()}
        stats = grad_statistics(params, grads)
        optimizer.step()
        metrics = dict(metrics, loss=loss)
        if dist.active():
            dist.all_reduce_mean_(dist.bn_running_stats(net))
            keys = list(metrics)
            flat = torch.stack([metrics[k].detach().float() for k in keys])
            metrics = dict(zip(keys, dist.all_reduce_mean_([flat])[0]))
        return {**{k: v.detach() for k, v in metrics.items()}, **stats}

    def step(batch: dict) -> dict:
        with annotate("roma.train.step"):
            net.train()
            optimizer.zero_grad()
            dev = next(iter(trainable.values())).device.type
            with annotate("roma.train.forward", device=True):
                with torch.autocast(dev, dtype=amp_dtype or torch.bfloat16, enabled=amp_dtype is not None):
                    corresps = forward(net, batch)
                loss, metrics = objective(corresps, batch)
            with annotate("roma.train.backward", device=True):
                loss.backward()
            with annotate("roma.train.optimizer", device=True):
                return update(loss, metrics)

    step.param_names = list(trainable)
    return step


def train_k_steps(
    state: TrainState,
    batches: Iterable[dict],
    train_step,
    progress: Callable | None = None,
    ema_decay: float | None = None,
    warn_nonfinite: bool = False,
):
    """Run the step over an iterable of batches (reference train/train.py:
    40-64 without the tqdm/wandb coupling). ``ema_decay`` keeps
    ``state.ema_params`` with the warmup-ramped decay; LR warmup is part of
    the optimizer's schedule. ``warn_nonfinite`` reads the finite mask back
    after each step (one host sync) and prints the offending names. Under a
    process group each batch is this rank's own (the loader's rank slice, or
    ``parallel.dist.shard_batch`` of a global batch)."""
    ema_update = None
    if ema_decay is not None:
        if state.ema_params is None:
            state.ema_params = {k: p.detach().float().clone() for k, p in state.net.named_parameters()}
        ema_update = make_ema_update(ema_decay)
    params = dict(state.net.named_parameters())
    metrics: dict = {}
    ema_t = state.step  # a resumed state keeps the ramp converged
    for batch in batches:
        metrics = train_step(batch)
        if ema_update is not None:
            ema_update(state.ema_params, params, ema_t)
            ema_t += 1
        state.step += 1
        if warn_nonfinite and float(metrics["nonfinite_grads"]) > 0:
            names = nonfinite_grad_names(train_step.param_names, metrics["grad_finite_mask"])
            print(f"These params have nan or inf grads: {names}")
        if progress is not None:
            progress(state.step, metrics)
    return state, metrics


def train_epoch(state: TrainState, loader, train_step):
    """One full pass over a loader (reference train/train.py:67-84)."""
    return train_k_steps(state, loader, train_step)


def train_k_epochs(state: TrainState, make_loader, train_step, k: int):
    """k epochs over freshly made loaders (reference train.py:87-102)."""
    metrics: dict = {}
    for _ in range(k):
        state, metrics = train_epoch(state, make_loader(), train_step)
    return state, metrics


def init_train_state(net: nn.Module, optimizer: RoMaOptimizer) -> TrainState:
    """The state of a fresh run; under a process group every rank takes rank
    0's parameters and buffers (the JAX package's ``replicate``)."""
    return TrainState(net=dist.replicate(net), optimizer=optimizer)
