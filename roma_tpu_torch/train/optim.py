"""Optimizer recipe (counterpart of roma_tpu/train/optim.py; reference
experiments/train_roma_outdoor.py:194-251): AdamW with weight decay 0.01 and
one learning rate for the encoder and one for the decoder, MultiStepLR decay
0.2 at the milestones with an optional linear warmup, and one global
gradient-norm clip at 0.01 over all trainable gradients before the update.

Frozen parameters (DINOv2, which does not require grad) are not in the
optimizer at all: no AdamW state (~2.4 GB of m and v for ViT-L) and, above
all, no weight decay, which would shrink the frozen backbone a little on
every step even with zero gradients. No GradScaler: bf16 has float32's
exponent range.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn


def in_encoder(name: str) -> bool:
    """The encoder parameter group: names under the top-level ``encoder``
    (RoMaNet) or ``xfeat`` (TinyRoMaNet; the two nets share no name)."""
    return name.split(".")[0] in ("encoder", "xfeat")


def multistep_lr(base_lr: float, milestones: tuple[int, ...], gamma: float = 0.2,
                 warmup_steps: int = 0) -> Callable[[int], float]:
    """torch MultiStepLR, times a linear warmup ``min(1, (step+1)/warmup)``,
    as a function of the 0-based count of updates already applied."""

    def schedule(step: int) -> float:
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr *= gamma
        if warmup_steps > 0:
            lr *= min(1.0, (step + 1) / warmup_steps)
        return lr

    return schedule


def ema_params(decay: float = 0.999):
    """Exponential moving average of parameters, as (init, update):
    ``ema = init(params)``; ``update(ema, params)`` moves it in place.
    Both take {name: tensor} dicts."""

    def init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: p.detach().float().clone() for k, p in params.items()}

    @torch.no_grad()
    def update(ema: dict, params: dict) -> dict:
        for k, e in ema.items():
            e.mul_(decay).add_(params[k].detach().float(), alpha=1 - decay)
        return ema

    return init, update


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, the
    rule of optax.clip_by_global_norm (torch's clip_grad_norm_ adds 1e-6 to
    the norm); returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.maximum(norm, torch.full_like(norm, max_norm))
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


class RoMaOptimizer:
    """Global clip, then AdamW over two parameter groups with their own
    schedules: the counterpart of the optax chain ``make_optimizer`` returns.

    ``step()`` clips the gradients of every trainable parameter as one
    vector, sets each group's learning rate for the current update from its
    schedule, applies AdamW, and counts the update."""

    def __init__(self, groups: dict[str, list[nn.Parameter]], schedules: dict[str, Callable],
                 weight_decay: float, grad_clip: float):
        self.schedules = schedules
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "name": name, "lr": schedules[name](0)} for name, ps in groups.items()],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        )
        self.count = 0

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if grads:
            clip_by_global_norm_(grads, self.grad_clip)
        for g in self.param_groups:
            g["lr"] = self.schedules[g["name"]](self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(
    net: nn.Module,
    encoder_lr: float,
    decoder_lr: float,
    milestones: tuple[int, ...],
    weight_decay: float = 0.01,
    grad_clip: float = 0.01,
    warmup_steps: int = 0,
) -> RoMaOptimizer:
    """Two-group AdamW + MultiStepLR (+ warmup) + global clip over ``net``'s
    parameters that require grad, grouped by :func:`in_encoder`."""
    groups: dict[str, list[nn.Parameter]] = {"encoder": [], "decoder": []}
    for name, p in net.named_parameters():
        if p.requires_grad:
            groups["encoder" if in_encoder(name) else "decoder"].append(p)
    schedules = {
        "encoder": multistep_lr(encoder_lr, milestones, warmup_steps=warmup_steps),
        "decoder": multistep_lr(decoder_lr, milestones, warmup_steps=warmup_steps),
    }
    return RoMaOptimizer(groups, schedules, weight_decay, grad_clip)
