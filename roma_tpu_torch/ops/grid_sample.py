"""NHWC grid sample with ``F.grid_sample`` semantics (counterpart of
roma_tpu/ops/grid_sample.py, pinned to torch by tests/test_ops.py): bilinear
or nearest (round half to even, as torch), zeros padding,
``align_corners=False``.

The source coordinate is ``ix = (x + 1) * W / 2 - 0.5``, the JAX package's
form; ``F.grid_sample`` rounds ``((x + 1) * W - 1) / 2`` instead, which at
W=864 moves the bilinear weights by ~1e-4 of the feature scale. The four
taps combine in float32 in the JAX order; the result keeps x's dtype.
"""
from __future__ import annotations

import torch


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample ``x`` (B, H, W, C) at ``grid`` (B, Hq, Wq, 2) in [-1, 1], (x, y)
    order -> (B, Hq, Wq, C)."""
    b, h, w, c = x.shape
    g = grid.float()
    ix = (g[..., 0] + 1) * w / 2 - 0.5
    iy = (g[..., 1] + 1) * h / 2 - 0.5
    flat = x.reshape(b * h * w, c)
    base = torch.arange(b, device=x.device).view(b, *([1] * (grid.ndim - 2))) * (h * w)
    if mode == "nearest":
        xi, yi = torch.round(ix).long(), torch.round(iy).long()
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        return flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)] * valid.to(x.dtype)
    if mode != "bilinear":
        raise ValueError(f"unsupported grid_sample mode: {mode}")
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0f)[..., None], (iy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        tap = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)].float()
        out = out + tap * (wgt * valid)
    return out.to(x.dtype)
