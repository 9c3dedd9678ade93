"""Coordinate-grid helpers (counterpart of roma_tpu/ops/coords.py).

Warps use the normalized convention: coordinates in [-1, 1]^2, (x, y)
channel order, pixel centers of an axis of length n at
linspace(-1 + 1/n, 1 - 1/n, n). Flows are channel-last ``(B, H, W, 2)``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _grid_np(h: int, w: int) -> np.ndarray:
    ys = np.linspace(-1 + 1 / h, 1 - 1 / h, h, dtype=np.float32)
    xs = np.linspace(-1 + 1 / w, 1 - 1 / w, w, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack((gx, gy), axis=-1)  # (h, w, 2), xy order


@functools.lru_cache(maxsize=64)
def _grid_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so a
    # later training step can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(_grid_np(h, w)).to(device)


def normalized_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) float32 grid of normalized pixel-center coordinates, (x, y)
    order. Cached per device, so the match path makes no host-to-device copy
    (a pageable copy would stall the host until the card catches up); the
    tensor is shared, so callers must not write to it."""
    return _grid_on(h, w, torch.device(device if device is not None else "cpu"))


def batched_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """(b, h, w, 2) broadcast view of :func:`normalized_grid` (the JAX
    package's ``batched_grid``, reference ``get_grid``)."""
    return normalized_grid(h, w, device).expand(b, h, w, 2)


def to_pixel_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized (x, y) in [-1, 1] -> pixel coordinates ([-1+1/n, 1-1/n] ->
    [0.5, n-0.5]; reference utils.py:521-531 ``flow_to_pixel_coords``)."""
    return torch.stack((w * (coords[..., 0] + 1) / 2, h * (coords[..., 1] + 1) / 2), dim=-1)


def to_normalized_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates -> normalized (x, y) in [-1, 1] (reference
    utils.py:535-545)."""
    return torch.stack((2 * coords[..., 0] / w - 1, 2 * coords[..., 1] / h - 1), dim=-1)


def warp_to_pixel_coords(warp: torch.Tensor, h1: int, w1: int, h2: int, w2: int) -> torch.Tensor:
    """A 4-channel warp (x1, y1, x2, y2) -> pixel coordinates in A and B
    (reference utils.py:549-570)."""
    return torch.cat((to_pixel_coords(warp[..., :2], h1, w1), to_pixel_coords(warp[..., 2:], h2, w2)), dim=-1)
