"""Kernel H's plain version (roma_tpu_torch.ops.fused_refiner_stack_packed
on CPU tensors) against the JAX package's packed channel-major refiner kernel
in interpret mode, at the three cases of tests/test_pallas_refiner.py's
test_packed_cmajor_bitexact_vs_cmajor, on the same folded blocks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import pallas_refiner as pr
from roma_tpu_torch.ops import fused_refiner_stack_packed


def _blocks(c, n, seed=0):
    """Folded blocks from the JAX package's fold_block, as numpy arrays."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        blk = pr.fold_block(
            jnp.asarray(rs.randn(5, 5, 1, c) * 0.2, jnp.float32),
            jnp.asarray(rs.randn(c) * 0.1, jnp.float32),
            jnp.asarray(1 + 0.1 * rs.randn(c), jnp.float32),
            jnp.asarray(0.1 * rs.randn(c), jnp.float32),
            jnp.asarray(0.05 * rs.randn(c), jnp.float32),
            jnp.asarray(np.abs(1 + 0.2 * rs.randn(c)), jnp.float32),
            jnp.asarray(rs.randn(1, 1, c, c) * (1.5 / np.sqrt(c)), jnp.float32),
            jnp.asarray(rs.randn(c) * 0.1, jnp.float32),
        )
        out.append({k: np.array(v) for k, v in blk.items()})
    return out


@pytest.mark.parametrize("c,h,w,nb,cg", [(24, 18, 22, 3, 8), (24, 40, 31, 3, 7), (9, 33, 40, 2, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_stack_matches_pallas_interpret(c, h, w, nb, cg, dtype):
    blocks = _blocks(c, nb)
    x = np.random.RandomState(3).randn(2, h, w, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(pr._fused_cmajor_packed(jnp.asarray(x, jdt), [{k: jnp.asarray(v) for k, v in b.items()}
                                                                    for b in blocks], interpret=True, cg=cg),
                     np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fused_refiner_stack_packed(tx, [{k: torch.from_numpy(v) for k, v in b.items()} for b in blocks],
                                     cg=cg)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, h, w, c)
    got = got.float().numpy()
    if dtype == "float32":  # F.conv2d sums in another order than the Pallas rolls
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    else:  # a bf16 rounding flip at one stage moves the next by an ulp
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    assert fused_refiner_stack_packed.launches == 0
