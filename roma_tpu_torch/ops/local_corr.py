"""Kernel B: bilinear local correlation around the current warp.

Replaces roma_tpu/ops/tile_window.py:_corr_kernel (entry
``windowed_local_corr``, routed at roma_tpu/ops/local_corr.py:300-318) and
the XLA corrvol/patch paths it sits beside. For query pixel i with warp
target w(i), the (2r+1)^2 window points one feature pixel apart around w(i)
share one bilinear fraction, so their corners tile a (2r+2)^2 integer patch:
dot f0[i] / sqrt(C) with each integer tap of f1 (zeros outside the image),
then fold the dots into the (2r+1)^2 bilinear taps, dy-major.

On the H100 the kernel (csrc/local_corr.cu) is bound by the instructions
its tap reads cost; its design note is in the source. Every radius takes
the kernel on CUDA (the JAX package sends r=7 to an XLA corrvol). The
wrapper checks its arguments in one pure function (:func:`corr_checks`),
which also picks the vector or the scalar path. A CPU tensor takes the
plain version :func:`local_correlation_reference`.
"""
from __future__ import annotations

import math

import torch

from .. import _ext
from ..utils.profiling import spanned


def _base_indices(warp: torch.Tensor, h: int, w: int):
    """Unnormalized warp -> integer corner y0, x0 and fractions fy, fx."""
    wf = warp.float()
    ix = (wf[..., 0] + 1) * w / 2 - 0.5
    iy = (wf[..., 1] + 1) * h / 2 - 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    return y0.long(), x0.long(), iy - y0, ix - x0


def integer_tap_dots(f0, f1, radius: int, y0, x0):
    """float32 (B, H, W, P, P), P = 2r + 2: f0[q] / sqrt(C) dotted with f1 at
    the integer taps (y0 + u - r, x0 + v - r), zero outside the image; one
    gather of f1 per tap."""
    b, h, w, c = f0.shape
    p = 2 * radius + 2
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
    return torch.stack(dots, dim=-1).reshape(b, h, w, p, p)


def bilinear_fold(dp, fy, fx):
    """(B, H, W, P, P) integer-tap dots and (B, H, W) fractions -> the
    (B, H, W, (P-1)^2) bilinear taps, dy-major: roma_tpu/ops/local_corr.py's
    shared-fraction corner combine."""
    b, h, w, p, _ = dp.shape
    fy, fx = fy[..., None, None], fx[..., None, None]
    out = (
        (1 - fy) * (1 - fx) * dp[..., :-1, :-1]
        + (1 - fy) * fx * dp[..., :-1, 1:]
        + fy * (1 - fx) * dp[..., 1:, :-1]
        + fy * fx * dp[..., 1:, 1:]
    )
    return out.reshape(b, h, w, (p - 1) ** 2)


def local_correlation_reference(f0, f1, radius: int, warp):
    """Plain PyTorch version: one gather of f1 per integer tap, then the
    shared-fraction corner combine of roma_tpu/ops/local_corr.py."""
    y0, x0, fy, fx = _base_indices(warp, f0.shape[1], f0.shape[2])  # (B, H, W)
    return bilinear_fold(integer_tap_dots(f0, f1, radius, y0, x0), fy, fx).to(f0.dtype)


VEC_BYTES = 16  # a lane's load of a row on the vector path
MAX_NV = 4      # the widest vector path: 4 loads a lane, 2048 bytes a row


def corr_checks(what, f0, f1, radius, warp):
    """Kernel B's argument contract, in one pass, before any launch: f0 and
    f1 (B, H, W, C) of one supported dtype (TypeError otherwise), warp
    (B, H, W, 2) float32, radius an int >= 0, every tensor contiguous and on
    f0's device (ValueError); f0 not requiring a gradient (RuntimeError).
    Picks the path: ``nv`` 16-byte loads a lane per row (1, 2 or 4) when a
    row is a whole number of 16-byte vectors and at most 128 of them (and an
    image under 2^31 of them), and then f0's and f1's bases must be 16-byte
    aligned (ValueError); else ``nv`` = 0, the scalar loop. Returns
    (B, H, W, C, nv)."""
    _ext.dtype_code(f0, what)
    b, h, w, c = f0.shape
    if f1.shape != f0.shape or f1.dtype != f0.dtype:
        raise ValueError(f"{what}: f1 {tuple(f1.shape)}/{f1.dtype} must match f0 {tuple(f0.shape)}/{f0.dtype}")
    if warp.shape != (b, h, w, 2) or warp.dtype != torch.float32:
        raise ValueError(f"{what}: warp must be float32 {(b, h, w, 2)}, got {warp.dtype} {tuple(warp.shape)}")
    if not isinstance(radius, int) or radius < 0:
        raise ValueError(f"{what}: radius must be an int >= 0, got {radius!r}")
    dev = f0.device
    if not all(t.is_contiguous() and t.device == dev for t in (f0, f1, warp)):
        raise ValueError(f"{what}: f0, f1 and warp must be contiguous and on one device")
    if f0.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    row = c * f0.element_size()
    nv = 0
    # the vector path indexes an image's vectors with 32-bit ints
    if row % VEC_BYTES == 0 and row <= MAX_NV * 32 * VEC_BYTES and h * w * row // VEC_BYTES < 2**31:
        nv = next(n for n in (1, 2, 4) if row <= n * 32 * VEC_BYTES)
        if f0.data_ptr() % VEC_BYTES or f1.data_ptr() % VEC_BYTES:
            raise ValueError(f"{what}: the {nv}-vector path reads rows of {row} bytes by 16-byte loads and needs "
                             f"f0's and f1's bases 16-byte aligned, got addresses {f0.data_ptr()} % 16 = "
                             f"{f0.data_ptr() % 16}, {f1.data_ptr()} % 16 = {f1.data_ptr() % 16}")
    return b, h, w, c, nv


@spanned("roma.ops.local_correlation")
def local_correlation(f0: torch.Tensor, f1: torch.Tensor, radius: int, warp: torch.Tensor):
    """f0, f1 (B, H, W, C); warp (B, H, W, 2) float32 A->B in [-1, 1] ->
    (B, H, W, (2r+1)^2) in f0's dtype."""
    if f0.device.type == "cpu":
        return local_correlation_reference(f0, f1, radius, warp)
    what = "local_correlation"
    if not f0.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {f0.device}")
    b, h, w, c, nv = corr_checks(what, f0, f1, radius, warp)
    k = (2 * radius + 1) ** 2
    out = torch.empty((b, h, w, k), dtype=f0.dtype, device=f0.device)
    if out.numel() == 0:
        return out
    rc = _ext.lib().roma_local_corr(
        f0.data_ptr(), f1.data_ptr(), warp.data_ptr(), out.data_ptr(), b, h, w, c, radius, nv,
        _ext.dtype_code(f0, what), _ext.stream(),
    )
    _ext.check(rc, what)
    local_correlation.launches += 1
    return out


local_correlation.launches = 0


def corr_volume_qmajor(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """(B, N0, N1) float32 correlation <f0_i, f1_j> / sqrt(C) of NHWC maps,
    f0's pixels first, outside autocast: Tiny RoMa's global correlation,
    whose matching softmax reduces over the last axis."""
    b, c = f0.shape[0], f0.shape[-1]
    with torch.autocast(f0.device.type, enabled=False):
        prod = torch.matmul(f0.reshape(b, -1, c).float(), f1.reshape(b, -1, c).float().transpose(1, 2))
    return prod / math.sqrt(c)


def corr_volume(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Global all-pairs correlation in the JAX package's layout
    (roma_tpu/ops/local_corr.py:corr_volume; reference tiny.py:178-191):
    f0, f1 (B, H, W, C) -> (B, H1, W1, H0, W0) float32 <f1_j, f0_i> / sqrt(C)."""
    b, h0, w0, _ = f0.shape
    h1, w1 = f1.shape[1:3]
    return corr_volume_qmajor(f1, f0).reshape(b, h1, w1, h0, w0)
