"""Gaussian KDE over match samples (counterpart of roma_tpu/ops/kde.py):
density_i = sum_j exp(-||x_i - x_j||^2 / (2 std^2)), with the pairwise term
as ||a||^2 + ||b||^2 - 2 a.b in row chunks so memory stays bounded.
"""
from __future__ import annotations

import torch


def kde(x: torch.Tensor, std: float = 0.1, chunk: int = 4096) -> torch.Tensor:
    """x: (N, D) samples -> (N,) float32 density."""
    xf = x.float()
    sq = (xf * xf).sum(-1)
    inv2s2 = 1.0 / (2.0 * std * std)
    out = []
    for i in range(0, xf.shape[0], chunk):
        rx, rsq = xf[i : i + chunk], sq[i : i + chunk]
        d2 = rsq[:, None] + sq[None, :] - 2.0 * (rx @ xf.T)
        out.append(torch.exp(-d2.clamp_min(0.0) * inv2s2).sum(-1))
    return torch.cat(out)
