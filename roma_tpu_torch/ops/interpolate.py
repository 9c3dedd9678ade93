"""NHWC resize with ``F.interpolate`` semantics (counterpart of
roma_tpu/ops/interpolate.py, whose matrices tests/test_ops.py pins to
torch's bilinear and bicubic rules, antialias off).

As in the JAX package the separable filter is two small dense products,
``out = R @ x @ C^T``, in float32, with the weight matrices built once per
(in, out, mode, scale) on the host. ``F.interpolate``'s CUDA bicubic kernel
walks every channel inside one thread per output pixel, which costs ~9 ms for
DINOv2's 1024-channel pos-embed grid on an H100; the products take
microseconds.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch's coefficients, a = -0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
        np.where(t < 2, (((t - 5) * t + 8) * t - 4) * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int, mode: str, scale: float | None) -> np.ndarray:
    """(n_out, n_in) float32 resize weights, align_corners=False. ``scale``
    (out/in) replaces the size-derived scale, as torch's ``scale_factor``
    code path does."""
    o = np.arange(n_out, dtype=np.float64)
    w = np.zeros((n_out, n_in), np.float64)
    if mode in ("nearest", "nearest-exact"):
        # torch's legacy 'nearest' takes floor(o * in/out), 'nearest-exact'
        # the pixel center's floor((o + 0.5) * in/out)
        src = (o + (0.5 if mode == "nearest-exact" else 0.0)) * n_in / n_out
        w[np.arange(n_out), np.floor(src).astype(np.int64).clip(0, n_in - 1)] = 1.0
        return w.astype(np.float32)
    src = (o + 0.5) * ((1.0 / scale) if scale is not None else n_in / n_out) - 0.5
    x0 = np.floor(src)
    f = src - x0
    if mode == "bilinear":
        taps = [(x0, 1 - f), (x0 + 1, f)]
    elif mode == "bicubic":
        taps = [(x0 - 1 + k, _cubic(f - (k - 1))) for k in range(4)]
    else:
        raise ValueError(f"unsupported resize mode: {mode}")
    for idx, wgt in taps:  # border replicate at the edges
        np.add.at(w, (np.arange(n_out), idx.astype(np.int64).clip(0, n_in - 1)), wgt)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_matrix_on(n_in, n_out, mode, scale, device) -> torch.Tensor:
    """The matrix, kept on ``device`` so a call makes no host-to-device copy
    (shared: read-only; a normal tensor even when made under inference_mode,
    so training can save it for backward)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(n_in, n_out, mode, scale)).to(device)


def interpolate(
    x: torch.Tensor,
    size: tuple[int, int],
    mode: str = "bilinear",
    scale_factor: tuple[float, float] | None = None,
) -> torch.Tensor:
    """Resize NHWC ``x`` (B, H, W, C) to ``size`` (bilinear, bicubic,
    nearest or nearest-exact, align_corners=False);
    ``scale_factor`` takes torch's scale_factor path (DINOv2's pos-embed
    resize relies on it). Computed in float32, returned in x's dtype."""
    h, w = x.shape[1:3]
    oh, ow = size
    if (oh, ow) == (h, w) and scale_factor is None:
        return x
    sr, sc = scale_factor if scale_factor is not None else (None, None)
    r = _resize_matrix_on(h, oh, mode, sr, x.device)
    c = _resize_matrix_on(w, ow, mode, sc, x.device)
    y = torch.einsum("oh,bhwc->bowc", r, x.float())
    y = torch.einsum("ow,bhwc->bhoc", c, y)
    return y.to(x.dtype)
