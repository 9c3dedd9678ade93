"""Kernel D's plain version (roma_tpu_torch.ops.fused_refiner_stack) against
the JAX package's channel-major Pallas refiner kernel in interpret mode, and
the port's BatchNorm folding against its unfolded eval-mode modules."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import pallas_refiner as pr
from roma_tpu_torch.models.blocks import nhwc, refiner_block
from roma_tpu_torch.ops import fold_block, fold_refiner, fused_refiner_stack

ATOL = 1e-4


def _torch_params(c, n, seed=0):
    """n blocks of torch-layout refiner params (conv1, BN, conv2)."""
    rs = np.random.RandomState(seed)
    f = lambda *s, scale=1.0, shift=0.0: (shift + scale * rs.randn(*s)).astype(np.float32)
    return [
        dict(
            dw_weight=f(c, 1, 5, 5, scale=0.2), dw_bias=f(c, scale=0.1),
            bn_weight=f(c, scale=0.1, shift=1.0), bn_bias=f(c, scale=0.1),
            bn_mean=f(c, scale=0.05), bn_var=np.abs(f(c, scale=0.2, shift=1.0)),
            pw_weight=f(c, c, 1, 1, scale=1.5 / np.sqrt(c)), pw_bias=f(c, scale=0.1),
        )
        for _ in range(n)
    ]


def _jax_fold(p):
    """The same params in flax layouts through the JAX package's fold_block."""
    return pr.fold_block(
        jnp.asarray(p["dw_weight"].transpose(2, 3, 1, 0)), jnp.asarray(p["dw_bias"]),
        jnp.asarray(p["bn_weight"]), jnp.asarray(p["bn_bias"]),
        jnp.asarray(p["bn_mean"]), jnp.asarray(p["bn_var"]),
        jnp.asarray(p["pw_weight"].transpose(2, 3, 1, 0)), jnp.asarray(p["pw_bias"]),
    )


@pytest.mark.parametrize("h,w", [(18, 22), (40, 31)])
def test_refiner_stack_matches_pallas_interpret(h, w):
    c, nb = 24, 9
    params = _torch_params(c, nb)
    jblocks = [_jax_fold(p) for p in params]
    tblocks = [fold_block(**{k: torch.from_numpy(v) for k, v in p.items()}) for p in params]
    for jb, tb in zip(jblocks, tblocks):
        for k in ("dw", "db", "w2", "b2"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6, atol=1e-7)
    x = np.random.RandomState(1).randn(2, h, w, c).astype(np.float32)
    ref = np.asarray(pr.fused_refiner_stack(jnp.asarray(x), jblocks, interpret=True))
    got = fused_refiner_stack(torch.from_numpy(x), tblocks).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert fused_refiner_stack.launches == 0


def test_fold_matches_unfolded_modules():
    c, nb = 24, 3
    blocks = [refiner_block(c, c) for _ in range(nb)]
    for seq, p in zip(blocks, _torch_params(c, nb, seed=2)):
        conv1, bn, _, conv2 = seq
        with torch.no_grad():
            conv1.weight.copy_(torch.from_numpy(p["dw_weight"]))
            conv1.bias.copy_(torch.from_numpy(p["dw_bias"]))
            bn.weight.copy_(torch.from_numpy(p["bn_weight"]))
            bn.bias.copy_(torch.from_numpy(p["bn_bias"]))
            bn.running_mean.copy_(torch.from_numpy(p["bn_mean"]))
            bn.running_var.copy_(torch.from_numpy(p["bn_var"]))
            conv2.weight.copy_(torch.from_numpy(p["pw_weight"]))
            conv2.bias.copy_(torch.from_numpy(p["pw_bias"]))
        seq.eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 17, 23, c).astype(np.float32))
    with torch.no_grad():
        ref = x
        for seq in blocks:
            ref = nhwc(seq, ref)
        got = fused_refiner_stack(x, fold_refiner(blocks[0], blocks[1:]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
