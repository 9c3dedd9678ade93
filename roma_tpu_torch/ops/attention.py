"""Scaled-dot-product attention (counterpart of roma_tpu/ops/attention.py:sdpa).

:func:`sdpa_reference` is the einsum form of the JAX package: logits in
float32, keys at index >= ``n_valid`` masked out of the softmax,
probabilities cast to the value dtype for the second product, float32
accumulation. It is the plain version that Kernel A (ops/fused_attention.py)
is checked against. :func:`sdpa` routes CUDA tensors with head dim 64 or 128
to the per-head kernel entry ``fused_attention``, as the JAX package routes
to its Pallas kernel on the TPU (roma_tpu/ops/attention.py:44-49), and every
other input to the einsum form.
"""
from __future__ import annotations

import math

import torch

# the head dims Kernel A and E take (csrc/attention.cu, attention_bwd.cu)
KERNEL_HEAD_DIMS = (64, 128)


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int | None = None):
    """q, k, v: (B, H, N, D) -> (B, H, N, D) in q's dtype."""
    n, d = q.shape[-2:]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if n_valid is not None and n_valid < n:
        logits[..., n_valid:] = float("-inf")
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int | None = None):
    """q, k, v: (B, H, N, D) -> (B, H, N, D); differentiable on every route."""
    if q.device.type == "cuda" and q.shape[-1] in KERNEL_HEAD_DIMS:
        from .fused_attention import fused_attention

        return fused_attention(q, k, v, n_valid)
    return sdpa_reference(q, k, v, n_valid)


# the JAX package's name for the packed entry (roma_tpu/ops/attention.py:
# attention_packed): the kernel wrapper itself. Imported last, as
# fused_attention imports sdpa_reference from here.
from .fused_attention import fused_attention_packed as attention_packed  # noqa: E402
