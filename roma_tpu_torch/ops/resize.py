"""Kernel M: Pillow's bicubic resize of uint8 RGB images, bit for bit, fused
with the [0, 1] scaling, the ImageNet normalization and the cast to the
net's dtype.

M replaces no TPU kernel: the JAX package resizes on the host with PIL
(roma_tpu/utils/image.py ``resize``, the reference's TupleResize), and so
did the port. On the H100 the single-pair match spent about a third of a
request in four such host resizes with the card idle, so
``RegressionMatcher.match`` now resizes PIL inputs on the card with M and
gets the bytes PIL gives.

Pillow's arithmetic (libImaging/Resample.c, 8 bits a channel): per axis,
:func:`pillow_coeffs` gives each output position its first input tap, its
tap count and its weights in 22-bit fixed point, computed in double in
Pillow's order. A pass sums ``pixel * weight`` in int32 onto ``1 << 21`` and
keeps ``clip8`` of the sum (``>> 22``, clamped to 0..255); the horizontal
pass runs first into a uint8 intermediate, then the vertical pass. Pillow
skips a pass whose size does not change; its table here is the identity (one
tap of weight ``1 << 22``), which gives the same bytes. Then the float ops
of ``imagenet_normalize(x.float() / 255.0).to(dtype)`` as PyTorch runs them
on the tensor's device.

On the H100 the kernel (csrc/resize.cu) is bound by bytes; its design note
is in the source. A CPU tensor takes the plain version
:func:`resize_normalize_reference`, the same integer arithmetic in torch ops.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _ext
from ..utils.image import imagenet_normalize
from ..utils.profiling import spanned

PRECISION_BITS = 22  # Pillow's PRECISION_BITS for 8-bit images: 32 - 8 - 2
BICUBIC_A = -0.5
BICUBIC_SUPPORT = 2.0
SMEM_BYTES = 48 * 1024  # a block's intermediate rows, without the opt-in
TILE_ROWS = (16, 8, 4, 2, 1)  # output rows a block, largest first
TILE_COLS = (64, 32, 16, 8, 4, 2, 1)  # output columns a block, largest first
INT_MAX = 2**31 - 1


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), each operation in double as the C
    source orders it."""
    a = BICUBIC_A
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=256)
def pillow_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """One axis of Pillow's 8-bit bicubic resample (precompute_coeffs, then
    normalize_coeffs_8bpc): int32 (out_size, 2 + K), each row the first
    input tap, the tap count n and n weights in 22-bit fixed point, padded
    with zeros to K, the largest n. The identity when the size does not
    change. Read-only: the cache hands the same array to every caller."""
    if in_size < 1 or out_size < 1:
        raise ValueError(f"pillow_coeffs: sizes must be >= 1, got {in_size} -> {out_size}")
    if in_size == out_size:
        tab = np.zeros((out_size, 3), np.int32)
        tab[:, 0] = np.arange(out_size)
        tab[:, 1] = 1
        tab[:, 2] = 1 << PRECISION_BITS
    else:
        scale = in_size / out_size
        filterscale = max(scale, 1.0)
        support = BICUBIC_SUPPORT * filterscale
        ss = 1.0 / filterscale
        center = (np.arange(out_size) + 0.5) * scale
        xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
        n = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
        k_max = int(n.max())
        taps = np.arange(k_max)
        live = taps[None, :] < n[:, None]
        k = np.where(live, _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss), 0.0)
        ww = np.zeros(out_size)
        for t in range(k_max):  # summed in tap order, as the C loop does
            ww = ww + k[:, t]
        k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
        k = k * (1 << PRECISION_BITS)
        fixed = np.trunc(np.where(k < 0, -0.5 + k, 0.5 + k))
        tab = np.zeros((out_size, 2 + k_max), np.int32)
        tab[:, 0], tab[:, 1], tab[:, 2:] = xmin, n, np.where(live, fixed, 0)
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=256)
def _device_table(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`pillow_coeffs` as an int32 tensor on ``device``, made once."""
    return torch.from_numpy(pillow_coeffs(in_size, out_size).copy()).to(device)


@functools.lru_cache(maxsize=256)
def resize_plan(in_h: int, out_h: int, out_w: int) -> tuple[int, int, int]:
    """The kernel's tile for a resize of in_h rows to (out_h, out_w):
    (rows, columns, span), span the most input rows a tile of that many
    output rows reads. The largest rows of TILE_ROWS, then columns of
    TILE_COLS, whose intermediate (span x columns x 3 bytes) fits SMEM_BYTES;
    ValueError where none does (a downscale by thousands)."""
    tab = pillow_coeffs(in_h, out_h)
    first, end = tab[:, 0].astype(np.int64), tab[:, 0].astype(np.int64) + tab[:, 1]
    for cols in TILE_COLS:
        for rows in TILE_ROWS:
            starts = np.arange(0, out_h, rows)
            span = int((end[np.minimum(starts + rows, out_h) - 1] - first[starts]).max())
            if span * cols * 3 <= SMEM_BYTES:
                return rows, cols, span
    raise ValueError(f"resize_normalize: a downscale of {in_h} -> {out_h} rows reads more input rows than a "
                     f"block holds ({SMEM_BYTES} bytes)")


def resize_checks(what: str, x: torch.Tensor, hw, dtype: torch.dtype) -> tuple[int, int]:
    """The argument contract, before any work: x uint8 (B, H, W, 3),
    contiguous, on the CPU or a CUDA device; hw two sizes >= 1; dtype
    float32 or bfloat16 (TypeError); x's and the output's element counts
    under 2^31, B and the tiles' grid within a launch (ValueError). Returns
    (h, w)."""
    if dtype not in _ext.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32, bfloat16)")
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: x must be uint8, got {x.dtype}")
    if x.ndim != 4 or x.shape[-1] != 3 or min(x.shape) < 1:
        raise ValueError(f"{what}: x must be (B, H, W, 3) RGB with B, H, W >= 1, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: x must be on a CUDA device or the CPU, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    h, w = (int(s) for s in hw)
    if min(h, w) < 1:
        raise ValueError(f"{what}: output size must be >= 1, got {(h, w)}")
    if x.numel() > INT_MAX or x.shape[0] * h * w * 3 > INT_MAX or x.shape[0] > 65535 or h > 65535:
        raise ValueError(f"{what}: x {tuple(x.shape)} -> {(h, w)} is beyond one launch (32-bit sizes, "
                         "B and h at most 65535)")
    return h, w


def _pass(x: torch.Tensor, tab: torch.Tensor, dim: int) -> torch.Tensor:
    """One of Pillow's passes along ``dim`` of int64 pixels: the taps'
    fixed-point sum onto 1 << 21, then clip8."""
    first, n, weights = tab[:, 0].long(), tab[:, 1], tab[:, 2:].long()
    shape = [1] * x.ndim
    shape[dim] = tab.shape[0]
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64, device=x.device)
    for t in range(weights.shape[1]):  # a padded tap has weight 0; its index only has to be valid
        idx = torch.where(t < n, first + t, first)
        acc = acc + x.index_select(dim, idx) * weights[:, t].reshape(shape)
    return (acc >> PRECISION_BITS).clamp_(0, 255)


def resize_u8_reference(x: torch.Tensor, hw) -> torch.Tensor:
    """Pillow's 8-bit bicubic resize in torch integer ops on x's device:
    uint8 (B, H, W, 3) -> uint8 (B, h, w, 3), the bytes
    ``Image.resize((w, h), BICUBIC)`` gives."""
    h, w = (int(s) for s in hw)
    xh = _pass(x.long(), _device_table(x.shape[2], w, x.device), 2)
    return _pass(xh, _device_table(x.shape[1], h, x.device), 1).to(torch.uint8)


def resize_normalize_reference(x: torch.Tensor, hw, dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: :func:`resize_u8_reference`, then the ops of
    the PIL path, ``imagenet_normalize(x.float() / 255.0).to(dtype)``."""
    return imagenet_normalize(resize_u8_reference(x, hw).float() / 255.0).to(dtype)


@spanned("roma.ops.resize_normalize")
def resize_normalize(x: torch.Tensor, hw, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> (B, h, w, 3) of ``dtype``: Pillow's
    bicubic resize to hw = (h, w), scaled to [0, 1] and ImageNet-normalized,
    bit for bit the PIL path's values on x's device."""
    what = "resize_normalize"
    h, w = resize_checks(what, x, hw, dtype)
    if x.device.type == "cpu":
        return resize_normalize_reference(x, (h, w), dtype)
    _ext.require_cuda(what, x)
    b, in_h, in_w, _ = x.shape
    rows, cols, span = resize_plan(in_h, h, w)
    xtab, ytab = _device_table(in_w, w, x.device), _device_table(in_h, h, x.device)
    out = torch.empty((b, h, w, 3), dtype=dtype, device=x.device)
    rc = _ext.lib().roma_resize_normalize(
        x.data_ptr(), out.data_ptr(), xtab.data_ptr(), ytab.data_ptr(), b, in_h, in_w, h, w,
        xtab.shape[1] - 2, ytab.shape[1] - 2, rows, cols, span, _ext.DTYPE_CODES[dtype], _ext.stream(),
    )
    _ext.check(rc, what)
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0
