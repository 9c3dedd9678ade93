"""Kernel B: bilinear local correlation around the current warp.

Replaces roma_tpu/ops/tile_window.py:_corr_kernel (entry
``windowed_local_corr``, routed at roma_tpu/ops/local_corr.py:300-318) and
the XLA corrvol/patch paths it sits beside. For query pixel i with warp
target w(i), the (2r+1)^2 window points one feature pixel apart around w(i)
share one bilinear fraction, so their corners tile a (2r+2)^2 integer patch:
dot f0[i] / sqrt(C) with each integer tap of f1 (zeros outside the image),
then fold the dots into the (2r+1)^2 bilinear taps, dy-major.

On the H100 the kernel (csrc/local_corr.cu) is bound by the f1 reads; its
design note is in the source. Every radius takes the kernel on CUDA (the JAX
package sends r=7 to an XLA corrvol). A CPU tensor takes the plain version
:func:`local_correlation_reference`.
"""
from __future__ import annotations

import math

import torch

from .. import _ext


def _base_indices(warp: torch.Tensor, h: int, w: int):
    """Unnormalized warp -> integer corner y0, x0 and fractions fy, fx."""
    wf = warp.float()
    ix = (wf[..., 0] + 1) * w / 2 - 0.5
    iy = (wf[..., 1] + 1) * h / 2 - 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    return y0.long(), x0.long(), iy - y0, ix - x0


def local_correlation_reference(f0, f1, radius: int, warp):
    """Plain PyTorch version: one gather of f1 per integer tap, then the
    shared-fraction corner combine of roma_tpu/ops/local_corr.py."""
    b, h, w, c = f0.shape
    p = 2 * radius + 2
    y0, x0, fy, fx = _base_indices(warp, h, w)  # (B, H, W)
    f0s = f0.float() / math.sqrt(c)
    f1_flat = f1.reshape(b * h * w, c)
    bidx = torch.arange(b, device=f0.device).view(b, 1, 1) * (h * w)
    dots = []
    for u in range(p):
        for v in range(p):
            yy, xx = y0 + (u - radius), x0 + (v - radius)
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = bidx + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            tap = f1_flat[idx].float()  # (B, H, W, C)
            dots.append((tap * f0s).sum(-1) * valid)
    dp = torch.stack(dots, dim=-1).reshape(b, h, w, p, p)
    fy, fx = fy[..., None, None], fx[..., None, None]
    out = (
        (1 - fy) * (1 - fx) * dp[..., :-1, :-1]
        + (1 - fy) * fx * dp[..., :-1, 1:]
        + fy * (1 - fx) * dp[..., 1:, :-1]
        + fy * fx * dp[..., 1:, 1:]
    )
    return out.reshape(b, h, w, (p - 1) ** 2).to(f0.dtype)


def local_correlation(f0: torch.Tensor, f1: torch.Tensor, radius: int, warp: torch.Tensor):
    """f0, f1 (B, H, W, C); warp (B, H, W, 2) float32 A->B in [-1, 1] ->
    (B, H, W, (2r+1)^2) in f0's dtype."""
    if f0.device.type == "cpu":
        return local_correlation_reference(f0, f1, radius, warp)
    what = "local_correlation"
    _ext.require_cuda(what, f0, f1, warp)
    b, h, w, c = f0.shape
    if f1.shape != f0.shape or f1.dtype != f0.dtype:
        raise ValueError(f"{what}: f1 {tuple(f1.shape)}/{f1.dtype} must match f0 {tuple(f0.shape)}/{f0.dtype}")
    if warp.shape != (b, h, w, 2) or warp.dtype != torch.float32:
        raise ValueError(f"{what}: warp must be float32 {(b, h, w, 2)}, got {warp.dtype} {tuple(warp.shape)}")
    k = (2 * radius + 1) ** 2
    out = torch.empty((b, h, w, k), dtype=f0.dtype, device=f0.device)
    if out.numel() == 0:
        return out
    rc = _ext.lib().roma_local_corr(
        f0.data_ptr(), f1.data_ptr(), warp.data_ptr(), out.data_ptr(), b, h, w, c, radius,
        _ext.dtype_code(f0, what), _ext.stream(),
    )
    _ext.check(rc, what)
    local_correlation.launches += 1
    return out


local_correlation.launches = 0
