"""Coarse-match classification -> continuous flow (counterpart of
roma_tpu/ops/cls_to_flow.py): softmax over the res^2 anchors, the argmax
cell and its four neighbours (x +- 1, y +- res in flat index space,
clamped), probability-weighted mean of their anchor coordinates.
"""
from __future__ import annotations

import math

import torch

from .coords import normalized_grid


def cls_to_flow_refine(cls_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) anchor logits -> (B, H, W, 2) flow in [-1, 1]."""
    c = cls_logits.shape[-1]
    res = round(math.sqrt(c))
    assert res * res == c, f"anchor count {c} is not a square"
    anchors = normalized_grid(res, res, device=cls_logits.device).reshape(c, 2)
    probs = torch.softmax(cls_logits.float(), dim=-1)
    mode = torch.argmax(probs, dim=-1)
    index = torch.stack((mode - 1, mode, mode + 1, mode - res, mode + res), dim=-1).clamp(0, c - 1)
    neigh_p = torch.gather(probs, -1, index)  # (B, H, W, 5)
    neigh_xy = anchors[index]  # (B, H, W, 5, 2)
    return (neigh_p[..., None] * neigh_xy).sum(-2) / neigh_p.sum(-1, keepdim=True)
