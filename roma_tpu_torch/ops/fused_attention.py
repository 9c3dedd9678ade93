"""Kernel A: attention straight from the packed qkv Linear output.

Replaces roma_tpu/ops/pallas_attention.py:_attn_packed_kernel (entry
``fused_attention_packed``). ``qkv`` is (B, N, 3C) laid out [q | k | v],
each segment head-major; the result is (B, N, C) token-major, the layout the
proj Linear reads, so neither the head split nor the head merge is ever a
transpose in memory. Keys at index >= ``n_valid`` are masked.

On the H100 the kernel (csrc/attention.cu) is bound by arithmetic; its
design note is in the source. A CPU tensor takes the plain version
:func:`attention_packed_reference`; a CUDA tensor launches the kernel or
raises. Forward only: the backward (the TPU package's _attn_bwd_kernel) is
still to be ported.
"""
from __future__ import annotations

import torch

from .. import _ext
from .attention import sdpa


def attention_packed_reference(qkv: torch.Tensor, num_heads: int, n_valid: int | None = None):
    """Plain PyTorch version: unpack, per-head ``sdpa``, merge heads."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = (
        qkv[:, :, i * c:(i + 1) * c].reshape(b, n, num_heads, d).transpose(1, 2)
        for i in range(3)
    )
    out = sdpa(q, k, v, n_valid=n_valid)
    return out.transpose(1, 2).reshape(b, n, c)


def fused_attention_packed(qkv: torch.Tensor, num_heads: int, n_valid: int | None = None):
    """(B, N, 3C) packed qkv -> (B, N, C); head dim C/num_heads in {64, 128}
    on CUDA, any on CPU."""
    if qkv.device.type == "cpu":
        return attention_packed_reference(qkv, num_heads, n_valid)
    what = "fused_attention_packed"
    _ext.require_cuda(what, qkv)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if c3 != 3 * c or d * num_heads != c or d not in (64, 128):
        raise ValueError(f"{what}: need (B, N, 3C) with head dim 64 or 128, got {qkv.shape}, {num_heads} heads")
    nv = n if n_valid is None else int(n_valid)
    if not 1 <= nv <= n:
        raise ValueError(f"{what}: n_valid={nv} outside [1, {n}]")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = _ext.lib().roma_attention_packed(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, d, nv,
        _ext.dtype_code(qkv, what), _ext.stream(),
    )
    _ext.check(rc, what)
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0
