"""Scaled-dot-product attention, plain PyTorch (counterpart of
roma_tpu/ops/attention.py:sdpa).

The einsum form of the JAX package: logits in float32, keys at index >=
``n_valid`` masked out of the softmax, probabilities cast to the value dtype
for the second product, float32 accumulation. It is the math that Kernel A
(ops/fused_attention.py) is checked against.
"""
from __future__ import annotations

import math

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int | None = None):
    """q, k, v: (B, H, N, D) -> (B, H, N, D) in q's dtype."""
    n, d = q.shape[-2:]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if n_valid is not None and n_valid < n:
        logits[..., n_valid:] = float("-inf")
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)
