"""Kernels I and J's plain versions (roma_tpu_torch's lane_refiner_stack and
hcw_refiner_stack on CPU tensors) against the JAX package's two wide-C
refiner kernels in interpret mode, at the shapes of
tests/test_pallas_refiner.py, in float32 and bfloat16, on the same folded
blocks; and one stack folded from torch-layout modules by the port's
fold_refiner."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graveyard.pallas_hcw_refiner import hcw_refiner_stack as jax_hcw_stack
from graveyard.pallas_refiner_lanemajor import lane_refiner_stack as jax_lane_stack
from roma_tpu.ops import pallas_refiner as pr
from roma_tpu_torch.graveyard.pallas_hcw_refiner import hcw_refiner_stack
from roma_tpu_torch.graveyard.pallas_refiner_lanemajor import lane_refiner_stack
from roma_tpu_torch.models.blocks import nhwc, refiner_block
from roma_tpu_torch.ops import (
    fold_refiner,
    hcw_refiner_block,
    lane_refiner_block,
    refiner_stack_reference,
    wide_refiner_stack_reference,
)

STACKS = {
    "lane": (lambda x, b: jax_lane_stack(x, b, interpret=True), lane_refiner_stack),
    "hcw": (lambda x, b: jax_hcw_stack(x, b, interpret=True, s_rows=5), lambda x, b: hcw_refiner_stack(x, b)),
}
# (stack, c, h, w, nb): tests/test_pallas_refiner.py:76-78 and :149-152
CASES = [("lane", 40, 14, 19, 2), ("lane", 144, 11, 9, 2),
         ("hcw", 40, 14, 19, 2), ("hcw", 144, 11, 9, 3), ("hcw", 16, 23, 31, 2), ("hcw", 29, 10, 13, 2)]


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


def bf16_ulp(v: float) -> float:
    """One bfloat16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("stack,c,h,w,nb", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_stack_matches_pallas_interpret(stack, c, h, w, nb, dtype):
    jax_fn, port_fn = STACKS[stack]
    blocks = _blocks(c, nb)
    x = np.random.RandomState(1).randn(2, h, w, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(jax_fn(jnp.asarray(x, jdt), [{k: jnp.asarray(v) for k, v in b.items()} for b in blocks]),
                     np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tblocks = [{k: torch.from_numpy(v) for k, v in b.items()} for b in blocks]
    counts = (lane_refiner_block.launches, hcw_refiner_block.launches)
    got = port_fn(tx, tblocks)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, h, w, c)
    got = got.float().numpy()
    if dtype == "float32":  # F.conv2d sums in another order than the Pallas kernels
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    else:  # the same roundings (w2 included); one summation-order flip is one ulp
        assert np.abs(got - ref).max() <= bf16_ulp(np.abs(ref).max())
    assert (lane_refiner_block.launches, hcw_refiner_block.launches) == counts == (0, 0)


def test_bf16_rounds_the_pointwise_weights():
    """The wide-C function rounds w2 to bf16 (the TPU kernels and JAX's
    refiner_stack_reference); Kernel D's plain version keeps it float32, and
    the two differ in bf16 while they agree in float32."""
    c, blocks = 40, [{k: torch.from_numpy(v) for k, v in b.items()} for b in _blocks(40, 2)]
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 14, 19, c).astype(np.float32))
    wide, narrow = (f(x.bfloat16(), blocks).float() for f in (wide_refiner_stack_reference, refiner_stack_reference))
    assert (wide - narrow).abs().max().item() >= bf16_ulp(narrow.abs().max().item()) / 2
    assert torch.equal(wide_refiner_stack_reference(x, blocks), refiner_stack_reference(x, blocks))


def test_torch_layout_modules_fold_like_jax():
    """refiner_block modules folded by the port's fold_refiner run the same
    stack as JAX's fold_block on the same weights in the flax layout, and as
    the modules themselves in eval mode (float32)."""
    c, n = 24, 3
    torch.manual_seed(0)
    mods = [refiner_block(c, c).eval() for _ in range(n)]
    with torch.no_grad():
        for m in mods:
            for bn_buf, shift in ((m[1].running_mean, 0.0), (m[1].running_var, 1.0)):
                bn_buf.copy_(shift + 0.1 * torch.rand(c))
            m[1].weight.add_(0.1 * torch.randn(c))
            m[1].bias.add_(0.1 * torch.randn(c))
        blocks = fold_refiner(mods[0], mods[1:])
    jblocks = []
    for m in mods:
        conv1, bn, _, conv2 = (t for t in m)
        a = lambda t: jnp.asarray(t.detach().numpy())
        jblocks.append(pr.fold_block(a(conv1.weight.permute(2, 3, 1, 0)), a(conv1.bias), a(bn.weight), a(bn.bias),
                                     a(bn.running_mean), a(bn.running_var), a(conv2.weight.permute(2, 3, 1, 0)),
                                     a(conv2.bias)))
    x = np.random.RandomState(2).randn(2, 12, 15, c).astype(np.float32)
    ref = np.asarray(jax_lane_stack(jnp.asarray(x), jblocks, interpret=True))
    tx = torch.from_numpy(x)
    with torch.no_grad():  # folded b2 is the module's bias parameter itself
        y = tx
        for m in mods:
            y = nhwc(m, y)
        for got in (lane_refiner_stack(tx, blocks), hcw_refiner_stack(tx, blocks), y):
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_hcw_block_takes_the_nhcw_layout():
    """hcw_refiner_block is the NHWC function on the transposed layout."""
    blocks = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _blocks(29, 1)]
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 10, 13, 29).astype(np.float32))
    got = hcw_refiner_block(x.permute(0, 1, 3, 2).contiguous(), blocks[0])
    assert got.is_contiguous() and tuple(got.shape) == (2, 10, 29, 13)
    # the same function; the CPU conv may pick another summation order per layout
    torch.testing.assert_close(got.permute(0, 1, 3, 2), lane_refiner_block(x, blocks[0]), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        hcw_refiner_stack(x, blocks, s_rows=0)
