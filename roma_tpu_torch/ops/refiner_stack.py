"""Kernels D and H: the narrow ConvRefiner stack with BatchNorm folded in.

Replaces roma_tpu/ops/pallas_refiner.py:_cmajor_kernel (entry
``fused_refiner_stack``, routed at roma_tpu/models/matcher.py:265-275 for
inference when hidden_dim <= 32: the scale-1 refiner, C=24). One folded
block is a depthwise KxK conv with the BatchNorm folded in (:func:`fold_block`),
bias, ReLU and a round to the I/O dtype, then a CxC 1x1 conv, bias and a
round, with zero SAME padding.

On the H100 Kernel D (csrc/refiner_stack.cu) runs once per folded block,
register-blocked with its pointwise product on the tensor cores in bf16 at
C = 24, K = 5 (the scale-1 stack), one thread per pixel at any other C <= 32
and odd K; :func:`stack_checks` holds its argument contract. Kernel H
(csrc/refiner_chain.cu, :func:`fused_refiner_stack_packed`) runs a group of
blocks per launch, as roma_tpu/ops/pallas_refiner.py's packed kernel does:
D's design at C = 24, K = 5 in bf16, one thread per pixel otherwise;
:func:`packed_checks` holds its contract.
Their design notes are in the sources. A CPU tensor takes the plain version
:func:`refiner_stack_reference`, the function of both.
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from .. import _ext
from ..utils.profiling import spanned
from .depthwise import depthwise_bn_relu_reference

BN_EPS = 1e-5
MAX_C = 32  # widest stack the kernel takes; the routing bound in models/matcher.py


def fold_block(dw_weight, dw_bias, bn_weight, bn_bias, bn_mean, bn_var, pw_weight, pw_bias):
    """Fold inference BatchNorm into the depthwise conv, all in float32.

    Takes torch layouts: dw_weight (C, 1, K, K), pw_weight (C_out, C_in, 1, 1).
    Returns dict(dw=(K, K, C), db=(C,), w2=(C_in, C_out), b2=(C,)), the layout
    of roma_tpu/ops/pallas_refiner.py:fold_block.
    """
    s = bn_weight.float() * torch.rsqrt(bn_var.float() + BN_EPS)
    dw = dw_weight.float()[:, 0].permute(1, 2, 0)  # (K, K, C)
    db = (dw_bias.float() - bn_mean.float()) * s + bn_bias.float()
    w2 = pw_weight.float()[:, :, 0, 0].T
    return dict(dw=(dw * s).contiguous(), db=db.contiguous(), w2=w2.contiguous(),
                b2=pw_bias.float().contiguous())


def fold_refiner(block1, hidden_blocks) -> list[dict]:
    """Folded blocks of a ConvRefiner's ``block1`` and ``hidden_blocks``
    (each nn.Sequential(conv KxK depthwise, BatchNorm2d, ReLU, conv 1x1))."""
    def fold(seq):
        conv1, bn, _, conv2 = seq
        return fold_block(conv1.weight, conv1.bias, bn.weight, bn.bias,
                          bn.running_mean, bn.running_var, conv2.weight, conv2.bias)
    return [fold(block1)] + [fold(blk) for blk in hidden_blocks]


def refiner_stack_reference(x: torch.Tensor, blocks: list[dict], round_w2: bool = False) -> torch.Tensor:
    """Plain PyTorch version, folded math in float32 with the I/O-dtype
    rounding after each stage (the TPU kernel's stores). ``round_w2`` also
    rounds the pointwise weights to the I/O dtype before the product, as the
    wide-C kernels and roma_tpu/ops/pallas_refiner.py:refiner_stack_reference
    do; Kernels D and H keep them in float32."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2)
    for blk in blocks:
        t = depthwise_bn_relu_reference(y.permute(0, 2, 3, 1), blk["dw"], blk["db"]).permute(0, 3, 1, 2).float()
        w2 = blk["w2"].to(dt).float() if round_w2 else blk["w2"]
        y = F.conv2d(t, w2.T[:, :, None, None], blk["b2"]).to(dt)
    return y.permute(0, 2, 3, 1)


VEC_C, VEC_K = 24, 5  # Kernel D's register-blocked, tensor-core instantiation
_WEIGHTS = ("dw", "db", "w2", "b2")


def stack_checks(what, x, blocks):
    """Kernel D's argument contract, in one pass, before any launch: x
    (B, H, W, C) of a supported dtype (TypeError otherwise), 1 <= C <=
    MAX_C; every folded block float32 dw (K, K, C) with K odd, db (C,),
    w2 (C, C), b2 (C,); every tensor contiguous and on x's device
    (ValueError); x not requiring a gradient (RuntimeError). Picks each
    block's instantiation: "c24k5" for C = VEC_C and K = VEC_K, whose
    16-byte loads need x's base 16-byte aligned (ValueError), else
    "generic". Returns (B, H, W, C, [(K, instantiation) a block])."""
    _ext.dtype_code(x, what)
    b, h, w, c = x.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"{what}: C={c} outside the kernel's 1..{MAX_C}")
    dev = x.device
    plan = []
    for i, blk in enumerate(blocks):
        ws = [blk[n] for n in _WEIGHTS]
        k = ws[0].shape[0]
        shapes = [tuple(t.shape) for t in ws]
        if (any(t.dtype != torch.float32 for t in ws) or shapes != [(k, k, c), (c,), (c, c), (c,)]
                or k % 2 == 0):
            raise ValueError(f"{what}: folded block {i} must be float32 dw (K, K, C) with K odd, db (C,), "
                             f"w2 (C, C), b2 (C,); got {shapes}")
        if not all(t.is_contiguous() and t.device == dev for t in ws):
            raise ValueError(f"{what}: folded block {i} must be contiguous and on x's device {dev}")
        plan.append((k, "c24k5" if (c, k) == (VEC_C, VEC_K) else "generic"))
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    if any(p == "c24k5" for _, p in plan) and x.data_ptr() % 16:
        raise ValueError(f"{what}: the C={VEC_C}, K={VEC_K} instantiation loads x by 16-byte vectors and needs "
                         f"its base 16-byte aligned, got address {x.data_ptr()} % 16 = {x.data_ptr() % 16}")
    return b, h, w, c, plan


@spanned("roma.ops.fused_refiner_stack")
def fused_refiner_stack(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """Run a chain of folded refiner blocks on x (B, H, W, C), C <= 32 on CUDA."""
    if x.device.type == "cpu":
        return refiner_stack_reference(x, blocks)
    what = "fused_refiner_stack"
    if not x.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {x.device}")
    b, h, w, c, plan = stack_checks(what, x, blocks)
    code = _ext.dtype_code(x, what)
    launch = _ext.lib().roma_refiner_block
    bufs = [torch.empty_like(x), torch.empty_like(x)]  # fresh allocations: 16-byte aligned
    for i, (blk, (k, _)) in enumerate(zip(blocks, plan)):
        out = bufs[i % 2]
        rc = launch(x.data_ptr(), *(blk[n].data_ptr() for n in _WEIGHTS), out.data_ptr(), b, h, w, c, k, code,
                    _ext.stream())
        _ext.check(rc, what)
        fused_refiner_stack.launches += 1
        x = out
    return x


fused_refiner_stack.launches = 0


# Kernel H's group sizes (blocks a launch): the c24k5 body's, and the
# generic body's in bf16 and float32 (two f32 planes with a halo of 18 do
# not fit a block's shared memory at 3)
C24_GROUP = 2
GENERIC_GROUP = {torch.bfloat16: 3, torch.float32: 2}
PACKED_PATH_CODES = {"generic": 0, "c24k5": 1}
INT_MAX = 2**31 - 1


def packed_checks(what, x, blocks):
    """Kernel H's argument contract, in one pass, before any launch: x
    (B, H, W, C) of a supported dtype (TypeError otherwise), 1 <= C <=
    MAX_C, under 2^31 elements; every folded block float32 dw (K, K, C) with
    one odd K for all, db (C,), w2 (C, C), b2 (C,); every tensor contiguous
    and on x's device (ValueError); x not requiring a gradient
    (RuntimeError). Picks the body: "c24k5" for bfloat16 at C = VEC_C, K =
    VEC_K (Kernel D's design over C24_GROUP blocks a launch; its 16-byte
    loads need x's base 16-byte aligned, ValueError), else "generic"
    (GENERIC_GROUP[dtype] blocks a launch). Returns (B, H, W, C, K, path,
    group)."""
    _ext.dtype_code(x, what)
    if x.ndim != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"{what}: C={c} outside the kernel's 1..{MAX_C}")
    if x.numel() > INT_MAX:
        raise ValueError(f"{what}: x must hold under 2^31 elements, got {tuple(x.shape)}")
    k = blocks[0]["dw"].shape[0] if blocks else VEC_K
    for i, blk in enumerate(blocks):
        ws = [blk[n] for n in _WEIGHTS]
        shapes = [tuple(t.shape) for t in ws]
        if (any(t.dtype != torch.float32 for t in ws) or shapes != [(k, k, c), (c,), (c, c), (c,)]
                or k % 2 == 0):
            raise ValueError(f"{what}: folded block {i} must be float32 dw (K, K, C) with one odd K for all "
                             f"blocks (K={k}), db (C,), w2 (C, C), b2 (C,); got {shapes}")
        if not all(t.is_contiguous() and t.device == x.device for t in ws):
            raise ValueError(f"{what}: folded block {i} must be contiguous and on x's device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    if x.dtype == torch.bfloat16 and (c, k) == (VEC_C, VEC_K):
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: the C={VEC_C}, K={VEC_K} body loads x by 16-byte vectors and needs its "
                             f"base 16-byte aligned, got address {x.data_ptr()} % 16 = {x.data_ptr() % 16}")
        return b, h, w, c, k, "c24k5", C24_GROUP
    return b, h, w, c, k, "generic", GENERIC_GROUP[x.dtype]


def packed_weights(blocks: list[dict]) -> list[torch.Tensor]:
    """The blocks' dw, db, w2 and b2, each stacked over the blocks (Kernel
    H's operands), made once and kept beside the list in its first block
    (``blocks[0]["packed"]``, with a weak reference and the version counter
    of every source tensor): remade when any source is another tensor or
    was written to."""
    srcs = [blk[n] for blk in blocks for n in _WEIGHTS]
    kept = blocks[0].get("packed")
    if (kept is None or len(kept[0]) != len(srcs)
            or any(ref() is not t or ver != t._version for (ref, ver), t in zip(kept[0], srcs))):
        stacked = [torch.stack([blk[n] for blk in blocks]) for n in _WEIGHTS]
        kept = blocks[0]["packed"] = ([(weakref.ref(t), t._version) for t in srcs], stacked)
    return kept[1]


@spanned("roma.ops.fused_refiner_stack_packed")
def fused_refiner_stack_packed(x: torch.Tensor, blocks: list[dict], s_rows: int = 32,
                               cg: int = 8) -> torch.Tensor:
    """The same chain as :func:`fused_refiner_stack`, several blocks per launch.

    Kernel H (csrc/refiner_chain.cu) replaces
    roma_tpu/ops/pallas_refiner.py:_cmajor_packed_kernel (entry
    ``_fused_cmajor_packed``): one launch runs a group of blocks over a tile
    with a halo of K // 2 pixels per block, the intermediate planes in shared
    memory; :func:`packed_checks` picks the body and the group. ``s_rows``
    (the tile's rows) and ``cg`` (the depthwise loop's channel chunk, at
    most 8 on the card) tile the generic body only, as on the TPU: they
    change nothing in the output, and the c24k5 body, whose tile is fixed
    in its source, ignores them. The function is the same as Kernel D's, so
    a CPU tensor takes :func:`refiner_stack_reference`.
    """
    if s_rows < 1 or cg < 1:
        raise ValueError(f"fused_refiner_stack_packed: s_rows={s_rows} and cg={cg} must be >= 1")
    if x.device.type == "cpu":
        return refiner_stack_reference(x, blocks)
    what = "fused_refiner_stack_packed"
    if not x.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {x.device}")
    b, h, w, c, k, path, g = packed_checks(what, x, blocks)
    if not blocks:
        return x
    ws = packed_weights(blocks)
    code = _ext.dtype_code(x, what)
    lib = _ext.lib()
    for i in range(0, len(blocks), g):
        n = min(g, len(blocks) - i)
        out = torch.empty_like(x)  # a fresh allocation: 16-byte aligned
        rc = lib.roma_refiner_chain(
            x.data_ptr(), *(t[i].data_ptr() for t in ws), out.data_ptr(),
            b, h, w, c, k, n, s_rows, cg, code, PACKED_PATH_CODES[path], _ext.stream(),
        )
        _ext.check(rc, what)
        fused_refiner_stack_packed.launches += 1
        x = out
    return x


fused_refiner_stack_packed.launches = 0
