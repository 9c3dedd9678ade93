"""Kernel A's plain version (roma_tpu_torch.ops.fused_attention) against the
JAX package's packed Pallas attention kernel in interpret mode, and the bf16
kernels' layout contract (check_bf16_views) on the views the model makes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from roma_tpu.ops.pallas_attention import fused_attention_packed as jax_packed
from roma_tpu_torch.ops import fused_attention_packed
from roma_tpu_torch.ops.fused_attention import _heads, _qkv_heads, check_bf16_views


@pytest.mark.parametrize("heads,c,nv", [(4, 256, 201), (2, 256, 201), (4, 256, None)])  # d=64, d=128
def test_packed_attention_matches_pallas_interpret(heads, c, nv):
    b, n = 2, 256
    rs = np.random.RandomState(3)
    qkv = rs.randn(b, n, 3 * c).astype(np.float32) * 0.3
    if nv is not None:
        qkv[:, nv:] *= 5.0  # padded-token content must be inert
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_packed(jnp.asarray(qkv), heads, n_valid=nv))
    got = fused_attention_packed(torch.from_numpy(qkv), heads, n_valid=nv).numpy()
    m = nv or n
    np.testing.assert_allclose(got[:, :m], ref[:, :m], atol=2e-5)
    assert fused_attention_packed.launches == 0  # CPU tensors never launch


def _packed_views(n, c, heads):
    """The views the bf16 kernels get from a packed (B, N, 3C) qkv: q, k, v
    and the token-major (B, N, C) output (the backward's dqkv and dout are
    views of the same shapes)."""
    qkv = torch.zeros(2, n, 3 * c, dtype=torch.bfloat16)
    out = torch.zeros(2, n, c, dtype=torch.bfloat16)
    return (*_qkv_heads(qkv, heads), _heads(out, heads))


@pytest.mark.parametrize("views", [
    lambda: _packed_views(1601, 1024, 16),  # DINOv2 ViT-L: 16 heads of 64
    lambda: _packed_views(1600, 1024, 8),   # TransformerDecoder: 8 heads of 128
    lambda: (torch.zeros(2, 3, 65, 128, dtype=torch.bfloat16),),  # per-head, contiguous
], ids=["dinov2-packed", "decoder-packed", "per-head"])
def test_bf16_alignment_contract_accepts_the_model_views(views):
    check_bf16_views("test", *views())


@pytest.mark.parametrize("view", [
    lambda: torch.zeros(2 * 3 * 65 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 3, 65, 64),
    lambda: _qkv_heads(torch.zeros(2, 65, 3 * 128 + 1, dtype=torch.bfloat16)[..., 1:], 2)[1],
    lambda: torch.zeros(2, 3, 65, 68, dtype=torch.bfloat16)[..., :64],
], ids=["base-plus-one-element", "packed-plus-one-element", "row-stride-68"])
def test_bf16_alignment_contract_refuses_misaligned_views(view):
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_bf16_views("test", view())
