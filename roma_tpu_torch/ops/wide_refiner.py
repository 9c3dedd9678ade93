"""Kernels I and J: one folded wide-C ConvRefiner block per launch.

Replace graveyard/pallas_refiner_lanemajor.py:_lane_kernel (Kernel I, NHWC)
and graveyard/pallas_hcw_refiner.py:_block_kernel (Kernel J, (B, H, C, W)),
the JAX package's two experiments on the wide-C refiner stacks (scales 16 to
2, C in {1377, 1137, 569, 144}). Neither is routed by the match path: the
JAX package keeps XLA convs there and the port keeps cuDNN
(roma_tpu_torch/models/matcher.py). Their callers are the stack entries in
roma_tpu_torch/graveyard/ and roma_tpu_torch/tools/bench_hcw_refiner.py.

A folded block (:func:`~roma_tpu_torch.ops.refiner_stack.fold_block`) is a
KxK depthwise conv with BatchNorm folded in, bias, ReLU and a round to the
I/O dtype, then a CxC 1x1 product with the weights rounded to the I/O dtype
(float32 accumulation), bias and a round, zero SAME padding. The weight
rounding is what the TPU kernels and the JAX reference do; Kernels D and H
keep the pointwise weights in float32. Both kernels are
csrc/wide_refiner.cu; a CPU tensor takes the plain version
:func:`wide_refiner_stack_reference`.
"""
from __future__ import annotations

import torch

from .. import _ext
from .refiner_stack import refiner_stack_reference

KSIZE = 5  # the kernels' depthwise size: the released refiners' 5x5


def wide_refiner_stack_reference(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """Plain version on NHWC: roma_tpu/ops/pallas_refiner.py:refiner_stack_reference."""
    return refiner_stack_reference(x, blocks, round_w2=True)


def _launch(what: str, x: torch.Tensor, blk: dict, layout: int, b: int, h: int, w: int, c: int):
    _ext.require_cuda(what, x)
    ws = [blk[n] for n in ("dw", "db", "w2", "b2")]
    _ext.require_cuda(what, x, *ws)
    shapes = [tuple(t.shape) for t in ws]
    if any(t.dtype != torch.float32 for t in ws) or shapes != [(KSIZE, KSIZE, c), (c,), (c, c), (c,)]:
        raise ValueError(f"{what}: the folded block must be float32 dw ({KSIZE}, {KSIZE}, C), db (C,), "
                         f"w2 (C, C), b2 (C,) with C={c}; got {shapes}")
    code = _ext.dtype_code(x, what)
    out = torch.empty_like(x)
    rc = _ext.lib().roma_wide_refiner_block(
        x.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(), b, h, w, c, layout, code, _ext.stream()
    )
    _ext.check(rc, what)
    return out


def lane_refiner_block(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """One folded block on NHWC x (B, H, W, C), any C: Kernel I."""
    if x.device.type == "cpu":
        return wide_refiner_stack_reference(x, [blk])
    b, h, w, c = x.shape
    out = _launch("lane_refiner_block", x, blk, 0, b, h, w, c)
    lane_refiner_block.launches += 1
    return out


lane_refiner_block.launches = 0


def hcw_refiner_block(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """One folded block on x in the (B, H, C, W) layout, any C: Kernel J."""
    if x.device.type == "cpu":
        return wide_refiner_stack_reference(x.permute(0, 1, 3, 2), [blk]).permute(0, 1, 3, 2).contiguous()
    b, h, c, w = x.shape
    out = _launch("hcw_refiner_block", x, blk, 1, b, h, w, c)
    hcw_refiner_block.launches += 1
    return out


hcw_refiner_block.launches = 0
