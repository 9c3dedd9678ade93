"""Kernels A and E: attention forward and backward, as autograd functions.

Kernel A (csrc/attention.cu) replaces roma_tpu/ops/pallas_attention.py:
_attn_packed_kernel (entry :func:`fused_attention_packed`) and
:_attn_kernel (entry :func:`fused_attention`); Kernel E
(csrc/attention_bwd.cu) replaces :_attn_bwd_kernel, the backward of both
(:func:`fused_attention_backward`). Both kernels read and write (B, H, N, D)
views through strides: the packed path hands them head views of the qkv
Linear output (B, N, 3C), laid out [q | k | v] with each segment
head-major, of the token-major (B, N, C) output and of the packed dqkv, so
neither the forward nor the backward makes a head split or merge in memory
(the JAX package's packed backward pays those transposes,
pallas_attention.py:369-378). Keys at index >= ``n_valid`` are masked.

Under grad the forward also writes the float32 row log-sum-exp, which E
rebuilds the probabilities from: the TPU backward keeps a whole logit row
block in VMEM and needs none, but one (64, 1600) float32 tile is more than a
Hopper block's shared memory, so E streams key tiles and takes the row
statistics from the forward instead of recomputing them in a pass of its own.

On the H100 both kernels are bound by arithmetic; their design notes are in
the sources. In bf16 both run on the tensor cores (mma.sync, tiles staged by
16-byte cp.async copies), which needs every view's base 16-byte aligned and
its batch, head and row strides multiples of 8 elements
(:func:`check_bf16_views`, called before each bf16 launch); in float32 they
run on the CUDA cores and take any strides. A CPU tensor takes the plain versions
(:func:`attention_packed_reference`, ``sdpa_reference`` and
:func:`attention_backward_reference`); a CUDA tensor launches the kernels or
raises.
"""
from __future__ import annotations

import math

import torch

from .. import _ext
from ..utils.profiling import spanned
from .attention import KERNEL_HEAD_DIMS, sdpa_reference


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) token-major -> (B, H, N, D) view."""
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def _qkv_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3C) packed [q | k | v] -> three (B, H, N, D) views."""
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, num_heads, c3 // (3 * num_heads)).permute(2, 0, 3, 1, 4).unbind(0)


def _n_valid(what: str, n: int, n_valid: int | None) -> int:
    nv = n if n_valid is None else int(n_valid)
    if not 1 <= nv <= n:
        raise ValueError(f"{what}: n_valid={nv} outside [1, {n}]")
    return nv


def attention_packed_reference(qkv: torch.Tensor, num_heads: int, n_valid: int | None = None):
    """Plain PyTorch version of the packed forward: unpack, per-head
    einsum attention, merge heads."""
    b, n, c3 = qkv.shape
    out = sdpa_reference(*_qkv_heads(qkv, num_heads), n_valid=n_valid)
    return out.transpose(1, 2).reshape(b, n, c3 // 3)


def attention_backward_reference(q, k, v, dout, n_valid: int | None = None):
    """Plain PyTorch version of the backward, in float32: an explicit
    recompute of the probabilities and ``ds = p o (dp - rowsum(dp o p))``.
    ``p`` and ``ds`` are rounded to the inputs' dtype before the second
    products (``p^T dout``, ``ds k``, ``ds^T q``), where Kernel E rounds them
    and as :func:`sdpa_reference` rounds ``p`` for ``p v``; in float32 that is
    no rounding. q, k, v, dout (B, H, N, D) -> (dq, dk, dv) in the inputs'
    dtypes."""
    n, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if n_valid is not None and n_valid < n:
        logits[..., n_valid:] = float("-inf")
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_views(what: str, *views: torch.Tensor):
    """Views of one launch: one shape and dtype, head dim 64 or 128."""
    _ext.require_cuda(what, *views, strided=True)
    shape, dt = views[0].shape, views[0].dtype
    if any(t.shape != shape or t.dtype != dt for t in views) or len(shape) != 4:
        raise ValueError(f"{what}: q, k, v, out must share one (B, H, N, D) shape and dtype")
    if shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim must be 64 or 128, got {shape[-1]}")


def check_bf16_views(what: str, *views: torch.Tensor):
    """The bf16 kernels' layout contract: each 16-byte cp.async copy moves 8
    elements of a row, so every view's base address must be a multiple of 16
    bytes and its batch, head and row strides multiples of 8 elements.
    Raises ``ValueError`` otherwise; the kernels have no other path."""
    for t in views:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{what}: bf16 views need a 16-byte aligned base and strides that are "
                             f"multiples of 8 elements, got address {t.data_ptr()} % 16 = "
                             f"{t.data_ptr() % 16}, strides {t.stride()}")


def _launch_forward(what, q, k, v, out, lse, n_valid):
    """Kernel A on (B, H, N, D) views; q, k, v share strides."""
    _check_views(what, q, k, v, out)
    if q.dtype == torch.bfloat16:
        check_bf16_views(what, q, k, v, out)
    b, h, n, d = q.shape
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(f"{what}: q, k and v must share strides")
    if lse is not None:
        _ext.require_cuda(what, lse)
    rc = _ext.lib().roma_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, n, d, _n_valid(what, n, n_valid),
        *q.stride()[:3], *out.stride()[:3], _ext.dtype_code(q, what), _ext.stream(),
    )
    _ext.check(rc, what)


def _packed_forward(qkv: torch.Tensor, num_heads: int, n_valid, with_lse: bool):
    if qkv.device.type == "cpu":
        return attention_packed_reference(qkv, num_heads, n_valid), None
    what = "fused_attention_packed"
    _ext.require_cuda(what, qkv)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c % num_heads:
        raise ValueError(f"{what}: need (B, N, 3C) with C divisible by {num_heads} heads, got {qkv.shape}")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device) if with_lse else None
    _launch_forward(what, *_qkv_heads(qkv, num_heads), _heads(out, num_heads), lse, n_valid)
    fused_attention_packed.launches += 1
    return out, lse


def _head_forward(q, k, v, n_valid, with_lse: bool):
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v, n_valid), None
    what = "fused_attention"
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if with_lse else None
    _launch_forward(what, q, k, v, out, lse, n_valid)
    fused_attention.launches += 1
    return out, lse


@spanned("roma.ops.fused_attention_backward")
def fused_attention_backward(q, k, v, out, lse, dout, dq, dk, dv, n_valid: int | None = None):
    """Kernel E: gradients of the attention into ``dq``, ``dk``, ``dv``.

    All (B, H, N, D) views: q, k, v, dq, dk, dv share one set of strides,
    ``out`` (the forward's output) and ``dout`` another; ``lse`` (B, H, N)
    float32 is the forward's row log-sum-exp. A CPU tensor takes
    :func:`attention_backward_reference` (which needs neither out nor lse)."""
    if q.device.type == "cpu":
        for g, t in zip((dq, dk, dv), attention_backward_reference(q, k, v, dout, n_valid)):
            g.copy_(t)
        return dq, dk, dv
    what = "fused_attention_backward"
    _check_views(what, q, k, v, out, dout, dq, dk, dv)
    b, h, n, d = q.shape
    if any(t.stride() != q.stride() for t in (k, v, dq, dk, dv)) or dout.stride() != out.stride():
        raise ValueError(f"{what}: q, k, v, dq, dk, dv must share strides, and out, dout")
    if q.dtype == torch.bfloat16:
        check_bf16_views(what, q, k, v, out, dout, dq, dk, dv)
    _ext.require_cuda(what, lse)
    if lse.shape != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be float32 {(b, h, n)}, got {lse.dtype} {tuple(lse.shape)}")
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    rc = _ext.lib().roma_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, n, d, _n_valid(what, n, n_valid), *q.stride()[:3], *out.stride()[:3],
        _ext.dtype_code(q, what), _ext.stream(),
    )
    _ext.check(rc, what)
    fused_attention_backward.launches += 1
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """Kernel A packed forward, Kernel E backward into a packed dqkv."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, num_heads, n_valid):
        train = ctx.needs_input_grad[0]
        out, lse = _packed_forward(qkv, num_heads, n_valid, with_lse=train)
        if train:
            ctx.save_for_backward(qkv, out, lse)
            ctx.num_heads, ctx.n_valid = num_heads, n_valid
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        # E reads dout in the qkv dtype, as the JAX backward casts `do`; the
        # incoming gradient of the proj Linear need not be contiguous
        dout = dout.to(qkv.dtype).contiguous()
        dqkv = torch.empty_like(qkv)
        fused_attention_backward(*_qkv_heads(qkv, h), _heads(out, h), lse, _heads(dout, h),
                                 *_qkv_heads(dqkv, h), n_valid=ctx.n_valid)
        return dqkv, None, None


class _HeadAttention(torch.autograd.Function):
    """Kernel A per-head forward, Kernel E per-head backward."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, n_valid):
        train = any(ctx.needs_input_grad[:3])
        out, lse = _head_forward(q, k, v, n_valid, with_lse=train)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.n_valid = n_valid
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q, k, v = (t.contiguous() for t in (q, k, v))
        dout = dout.to(q.dtype).contiguous()
        grads = tuple(torch.empty_like(q) for _ in range(3))
        return (*fused_attention_backward(q, k, v, out, lse, dout, *grads, n_valid=ctx.n_valid), None)


@spanned("roma.ops.fused_attention_packed")
def fused_attention_packed(qkv: torch.Tensor, num_heads: int, n_valid: int | None = None):
    """(B, N, 3C) packed qkv -> (B, N, C), differentiable; head dim
    C/num_heads in {64, 128} on CUDA, any on CPU."""
    return _PackedAttention.apply(qkv, num_heads, n_valid)


@spanned("roma.ops.fused_attention")
def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int | None = None):
    """q, k, v (B, H, N, D) -> (B, H, N, D), differentiable; head dim in
    {64, 128} on CUDA, any on CPU."""
    return _HeadAttention.apply(q, k, v, n_valid)


fused_attention_packed.launches = 0
fused_attention.launches = 0
fused_attention_backward.launches = 0
