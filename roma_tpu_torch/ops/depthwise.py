"""Kernel N: the depthwise half of a folded wide ConvRefiner block, and the
wide stack it runs in.

Replaces no TPU kernel: the JAX package leaves the wide stacks (scales 16 to
2, C = 1377, 1137, 569, 144) to XLA's convolutions. In inference a folded
block (:func:`~roma_tpu_torch.ops.refiner_stack.fold_block`) is
``round(relu(depthwise(x) + db))``, Kernel N (csrc/depthwise.cu, one pass
over NHWC), then ``round(t @ w2 + b2)``, one library GEMM whose epilogue adds
the bias (:func:`wide_stack`). The stack's channels are padded once, with
zeros, to a multiple of C_ALIGN (:func:`padded_width`: 1384, 1144, 576, 144):
every pixel then starts on 16 bytes for N's copies and the GEMM's rows, and
no pass pads a block's input. The padded channels carry zero weights and
biases, so they stay exactly zero through every block.

A CPU tensor takes the plain version :func:`depthwise_bn_relu_reference`,
the first stage of
:func:`~roma_tpu_torch.ops.refiner_stack.refiner_stack_reference`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext
from ..utils.profiling import spanned

KSIZE = 5  # the kernel's depthwise size: the released refiners' 5x5
C_ALIGN = 8  # the channel multiple the kernel takes (16 bytes of bf16)


def padded_width(c: int) -> int:
    """The smallest multiple of C_ALIGN that holds ``c`` channels."""
    return -(-c // C_ALIGN) * C_ALIGN


def depthwise_bn_relu_reference(x: torch.Tensor, dw: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain version on NHWC x (B, H, W, C): the KxK depthwise conv with the
    folded weights dw (K, K, C) and bias db (C,) in float32, zero SAME
    padding, ReLU, one rounding to x's dtype."""
    k = dw.shape[0]
    t = F.conv2d(x.permute(0, 3, 1, 2).float(), dw.permute(2, 0, 1)[:, None], db, padding=k // 2,
                 groups=x.shape[-1])
    return torch.relu(t).to(x.dtype).permute(0, 2, 3, 1)


def depthwise_checks(what, x, dw, db):
    """Kernel N's argument contract, in one pass, before any launch: x
    (B, H, W, C) of a supported dtype (TypeError otherwise), C a multiple of
    C_ALIGN, B and H, W >= 1; dw (KSIZE, KSIZE, C) and db (C,) float32; every
    tensor contiguous and on x's device, x's base 16-byte aligned (its
    pixels are copied by 16-byte vectors), dw's and db's 8-byte aligned
    (ValueError); x not requiring a gradient (RuntimeError). Returns (B, H,
    W, C)."""
    _ext.dtype_code(x, what)
    if x.ndim != 4 or min(x.shape) < 1 or x.shape[-1] % C_ALIGN:
        raise ValueError(f"{what}: x must be (B, H, W, C) with C a multiple of {C_ALIGN}, got {tuple(x.shape)}")
    c = x.shape[-1]
    if dw.dtype != torch.float32 or db.dtype != torch.float32 or (tuple(dw.shape), tuple(db.shape)) != (
            (KSIZE, KSIZE, c), (c,)):
        raise ValueError(f"{what}: dw must be float32 ({KSIZE}, {KSIZE}, {c}) and db float32 ({c},), got "
                         f"{dw.dtype} {tuple(dw.shape)}, {db.dtype} {tuple(db.shape)}")
    if not all(t.is_contiguous() and t.device == x.device for t in (x, dw, db)):
        raise ValueError(f"{what}: x, dw and db must be contiguous and on one device")
    if x.data_ptr() % 16 or dw.data_ptr() % 8 or db.data_ptr() % 8:
        raise ValueError(f"{what}: x's base must be 16-byte aligned and dw's and db's 8-byte aligned, got "
                         f"addresses {x.data_ptr()}, {dw.data_ptr()}, {db.data_ptr()}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    return tuple(x.shape)


@spanned("roma.ops.depthwise_bn_relu")
def depthwise_bn_relu(x: torch.Tensor, dw: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """``round(relu(depthwise(x) + db))`` on NHWC x, C a multiple of C_ALIGN:
    Kernel N on CUDA."""
    if x.device.type == "cpu":
        return depthwise_bn_relu_reference(x, dw, db)
    what = "depthwise_bn_relu"
    if not x.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {x.device}")
    b, h, w, c = depthwise_checks(what, x, dw, db)
    out = torch.empty_like(x)
    rc = _ext.lib().roma_depthwise_bn_relu(x.data_ptr(), dw.data_ptr(), db.data_ptr(), out.data_ptr(), b, h, w, c,
                                           _ext.dtype_code(x, what), _ext.stream())
    _ext.check(rc, what)
    depthwise_bn_relu.launches += 1
    return out


depthwise_bn_relu.launches = 0


def padded_block(blk: dict, cp: int, dtype: torch.dtype) -> dict:
    """A folded block's operands at ``cp`` channels, zero-padded: dw (K, K,
    cp) and db (cp,) float32 for Kernel N; w2 (cp, cp), the pointwise weight
    as (in, out), and b2 (cp,) in the I/O ``dtype`` for the GEMM."""
    n = cp - blk["db"].shape[0]
    return dict(dw=F.pad(blk["dw"], (0, n)), db=F.pad(blk["db"], (0, n)),
                w2=F.pad(blk["w2"].to(dtype), (0, n, 0, n)), b2=F.pad(blk["b2"].to(dtype), (0, n)))


def wide_stack(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """A chain of blocks (:func:`padded_block`) on NHWC x (B, H, W, cp), x's
    channels past the blocks' C zero: per block Kernel N, then ``addmm(b2,
    t, w2)`` over the pixels (f32 accumulation; bf16 operands under
    autocast, as x and the blocks' w2 and b2 already are), written over the
    block's input, so a stack holds two maps, x and t. Returns x, the
    channels past C still zero."""
    cp = x.shape[-1]
    y = x.view(-1, cp)
    for blk in blocks:
        t = depthwise_bn_relu(x, blk["dw"], blk["db"])
        torch.addmm(blk["b2"], t.reshape(-1, cp), blk["w2"], out=y)
        del t
    return x
