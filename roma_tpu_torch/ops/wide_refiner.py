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

import weakref

import torch

from .. import _ext
from ..utils.profiling import spanned
from .refiner_stack import refiner_stack_reference

KSIZE = 5  # the kernels' depthwise size: the released refiners' 5x5


def wide_refiner_stack_reference(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """Plain version on NHWC: roma_tpu/ops/pallas_refiner.py:refiner_stack_reference."""
    return refiner_stack_reference(x, blocks, round_w2=True)


W2_ROWS, W2_COLS = 256, 192  # the tensor-core path's w2^T padding (csrc/wide_refiner.cu)
# the tensor-core paths' widest C: t (C x 32 pixels, bf16) beside three w2
# tiles of 256 x 64 (and I's 16 KB output chunk) in the 227 KB of shared
# memory an H100 block may take; the C entry checks the device's own limit
HCW_TC_MAX_C = 1472
INT_MAX = 2**31 - 1  # the tensor-core path indexes elements with 32-bit ints
PATH_CODES = {"tile8x8": 0, "hcw_tc": 1, "nhwc_tc": 2}
_WEIGHTS = ("dw", "db", "w2", "b2")


def wide_block_checks(what, x, blk, layout):
    """Kernels I and J's argument contract, in one pass, before any launch:
    x 4-D of a supported dtype (TypeError otherwise), (B, H, W, C) for
    layout 0 (I) or (B, H, C, W) for layout 1 (J); the folded block float32
    dw (5, 5, C), db (C,), w2 (C, C), b2 (C,); every tensor contiguous and
    on x's device (ValueError); x not requiring a gradient (RuntimeError).
    Picks the path: in bfloat16 the tensor-core kernels, C <= HCW_TC_MAX_C
    and x under 2^31 elements: "hcw_tc" for layout 1 (x's base 8-byte
    aligned at W % 4 == 0 and 4-byte aligned at an even W, whose rows it
    copies by 8-byte vectors or element pairs), "nhwc_tc" for layout 0 (x's
    base 16-byte aligned at C % 8 == 0, whose pixels it copies by 16-byte
    vectors, else 4-byte aligned, as it loads element pairs by aligned
    words); "tile8x8" in float32 and for layout 0 above HCW_TC_MAX_C.
    Returns (B, H, W, C, path)."""
    _ext.dtype_code(x, what)
    if x.ndim != 4 or layout not in (0, 1):
        raise ValueError(f"{what}: x must be 4-D and layout 0 or 1, got {tuple(x.shape)}, layout {layout}")
    if layout == 0:
        b, h, w, c = x.shape
    else:
        b, h, c, w = x.shape
    ws = [blk[n] for n in _WEIGHTS]
    shapes = [tuple(t.shape) for t in ws]
    if any(t.dtype != torch.float32 for t in ws) or shapes != [(KSIZE, KSIZE, c), (c,), (c, c), (c,)]:
        raise ValueError(f"{what}: the folded block must be float32 dw ({KSIZE}, {KSIZE}, C), db (C,), "
                         f"w2 (C, C), b2 (C,) with C={c}; got {shapes}")
    if not all(t.is_contiguous() and t.device == x.device for t in (x, *ws)):
        raise ValueError(f"{what}: x and the folded block's dw, db, w2, b2 must be contiguous and on one device")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    if x.dtype != torch.bfloat16 or (layout == 0 and c > HCW_TC_MAX_C):
        return b, h, w, c, "tile8x8"
    if c > HCW_TC_MAX_C or x.numel() > INT_MAX:
        raise ValueError(f"{what}: the tensor-core path takes C <= {HCW_TC_MAX_C} and under 2^31 elements, "
                         f"got {tuple(x.shape)}")
    if layout == 1:  # rows along W by 8-byte vectors when W % 4 == 0, by pairs when W is even
        path, at, align = "hcw_tc", f"W = {w}", 8 if w % 4 == 0 else 4 if w % 2 == 0 else 1
    else:  # pixels along C by 16-byte vectors when C % 8 == 0, else by aligned words
        path, at, align = "nhwc_tc", f"C = {c}", 16 if c % 8 == 0 else 4
    if x.data_ptr() % align:
        raise ValueError(f"{what}: at {at} the tensor-core path copies x by {align}-byte vectors and "
                         f"needs its base {align}-byte aligned, got address {x.data_ptr()} % {align} = "
                         f"{x.data_ptr() % align}")
    return b, h, w, c, path


def padded_w2t(w2: torch.Tensor) -> torch.Tensor:
    """The tensor-core path's pointwise weights: w2^T (out, in) rounded to
    bfloat16, zero-padded to multiples of (W2_ROWS, W2_COLS) so its 16-byte
    tiles need no bounds."""
    c = w2.shape[0]
    out = torch.zeros(-(-c // W2_ROWS) * W2_ROWS, -(-c // W2_COLS) * W2_COLS, dtype=torch.bfloat16,
                      device=w2.device)
    out[:c, :c] = w2.T
    return out


def block_w2t(blk: dict) -> torch.Tensor:
    """:func:`padded_w2t` of a folded block, made once and kept beside it
    (``blk["w2t"]``, with the w2 it was made from and that tensor's version
    counter): remade when ``blk["w2"]`` is another tensor or was written to."""
    w2, kept = blk["w2"], blk.get("w2t")
    if kept is None or kept[0]() is not w2 or kept[1] != w2._version:
        kept = blk["w2t"] = (weakref.ref(w2), w2._version, padded_w2t(w2))
    return kept[2]


def _launch(what: str, x: torch.Tensor, blk: dict, layout: int):
    if not x.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {x.device}")
    b, h, w, c, path = wide_block_checks(what, x, blk, layout)
    w2 = blk["w2"] if path == "tile8x8" else block_w2t(blk)
    out = torch.empty_like(x)
    rc = _ext.lib().roma_wide_refiner_block(
        x.data_ptr(), blk["dw"].data_ptr(), blk["db"].data_ptr(), w2.data_ptr(), blk["b2"].data_ptr(),
        out.data_ptr(), b, h, w, c, layout, PATH_CODES[path], _ext.dtype_code(x, what), _ext.stream(),
    )
    _ext.check(rc, what)
    return out


@spanned("roma.ops.lane_refiner_block")
def lane_refiner_block(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """One folded block on NHWC x (B, H, W, C), any C: Kernel I (in
    bfloat16 on the tensor cores, C <= HCW_TC_MAX_C)."""
    if x.device.type == "cpu":
        return wide_refiner_stack_reference(x, [blk])
    out = _launch("lane_refiner_block", x, blk, 0)
    lane_refiner_block.launches += 1
    return out


lane_refiner_block.launches = 0


@spanned("roma.ops.hcw_refiner_block")
def hcw_refiner_block(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """One folded block on x in the (B, H, C, W) layout, any C: Kernel J."""
    if x.device.type == "cpu":
        return wide_refiner_stack_reference(x.permute(0, 1, 3, 2), [blk]).permute(0, 1, 3, 2).contiguous()
    out = _launch("hcw_refiner_block", x, blk, 1)
    hcw_refiner_block.launches += 1
    return out


hcw_refiner_block.launches = 0
