"""Kernel A's plain version (roma_tpu_torch.ops.fused_attention) against the
JAX package's packed Pallas attention kernel in interpret mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from roma_tpu.ops.pallas_attention import fused_attention_packed as jax_packed
from roma_tpu_torch.ops import fused_attention_packed


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
