"""Kernels I and J's plain versions (roma_tpu_torch's lane_refiner_stack and
hcw_refiner_stack on CPU tensors) against the JAX package's two wide-C
refiner kernels in interpret mode, at the shapes of
tests/test_pallas_refiner.py, in float32 and bfloat16, on the same folded
blocks; and one stack folded from torch-layout modules by the port's
fold_refiner; and the kernels' argument contract with the path it picks."""
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
from roma_tpu_torch.ops.wide_refiner import (
    HCW_TC_MAX_C,
    W2_COLS,
    W2_ROWS,
    block_w2t,
    padded_w2t,
    wide_block_checks,
)
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

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


# Kernels I and J's argument contract (ops.wide_refiner.wide_block_checks), a
# pure function: it runs on CPU tensors here as it runs before every launch
def _block(c):
    return {k: torch.from_numpy(v) for k, v in _blocks(c, 1)[0].items()}


@pytest.mark.parametrize("layout,dtype,c,path", [(0, "bfloat16", 144, "nhwc_tc"), (0, "float32", 37, "tile8x8"),
                                                 (1, "float32", 144, "tile8x8"), (1, "bfloat16", 144, "hcw_tc"),
                                                 (1, "bfloat16", 37, "hcw_tc"), (1, "bfloat16", 1377, "hcw_tc"),
                                                 (0, "bfloat16", 37, "nhwc_tc"), (0, "bfloat16", 1377, "nhwc_tc"),
                                                 (0, "bfloat16", 1137, "nhwc_tc"), (0, "float32", 1377, "tile8x8")])
def test_checks_pick_the_path(layout, dtype, c, path):
    shape = (2, 5, 12, c) if layout == 0 else (2, 5, c, 12)
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    assert wide_block_checks("t", x, _block(c), layout) == (2, 5, 12, c, path)


def test_checks_refuse_strided_x_and_weights():
    blk, x = _block(40), torch.zeros(1, 6, 40, 10, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wide_block_checks("t", x.transpose(2, 3).contiguous().transpose(2, 3), blk, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wide_block_checks("t", torch.zeros(1, 6, 10, 40, dtype=torch.bfloat16).transpose(2, 3), blk, 1)
    for name in ("w2", "dw"):
        bad = dict(blk)
        bad[name] = blk[name].transpose(0, 1).contiguous().transpose(0, 1)  # the same values, strided
        assert torch.equal(bad[name], blk[name]) and not bad[name].is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            wide_block_checks("t", x, bad, 1)


def test_checks_refuse_bad_blocks():
    x = torch.zeros(1, 6, 40, 10, dtype=torch.bfloat16)
    bad = dict(_block(40), w2=torch.zeros(40, 41))
    with pytest.raises(ValueError, match="folded block"):
        wide_block_checks("t", x, bad, 1)
    with pytest.raises(ValueError, match="folded block"):
        wide_block_checks("t", x, {k: v.double() for k, v in _block(40).items()}, 1)
    with pytest.raises(TypeError):
        wide_block_checks("t", x.half(), _block(40), 1)


@pytest.mark.parametrize("layout,w,c,align", [(1, 10, 40, 4), (1, 11, 40, 1), (1, 12, 40, 8),
                                              (0, 10, 40, 16), (0, 11, 37, 4), (0, 12, 569, 4), (0, 9, 144, 16)])
def test_checks_refuse_a_misaligned_base_on_the_vector_paths(layout, w, c, align):
    """J's tensor-core path (layout 1) copies x's rows by 8-byte vectors at
    W % 4 == 0 and by element pairs at an even W, and needs its base aligned
    to that; at an odd W it loads elements one by one. I's (layout 0) copies
    a pixel's channels by 16-byte vectors at C % 8 == 0, else by the aligned
    words around element pairs."""
    blk = _block(c)
    flat = torch.zeros(6 * c * w + 16, dtype=torch.bfloat16)
    shape = (1, 6, c, w) if layout == 1 else (1, 6, w, c)
    view = lambda off: flat[off:off + 6 * c * w].view(shape)  # noqa: E731
    first = next(off for off in range(8) if view(off).data_ptr() % 16 == 0)
    path = "hcw_tc" if layout == 1 else "nhwc_tc"
    for off in range(1, 8):  # bases 2 to 14 bytes past 16
        if 2 * off % align:
            with pytest.raises(ValueError, match=f"{align}-byte aligned"):
                wide_block_checks("t", view(first + off), blk, layout)
        else:
            assert wide_block_checks("t", view(first + off), blk, layout)[-1] == path
    assert wide_block_checks("t", view(first), blk, layout)[-1] == path
    # the 8x8-tile path (float32) takes any base
    f32 = torch.zeros(6 * c * w + 4)[1:1 + 6 * c * w].view(shape)
    assert wide_block_checks("t", f32, blk, layout)[-1] == "tile8x8"


def test_checks_refuse_widths_past_the_tensor_core_path():
    c = HCW_TC_MAX_C + 32
    blk = {"dw": torch.empty(5, 5, c, device="meta"), "db": torch.empty(c, device="meta"),
           "w2": torch.empty(c, c, device="meta"), "b2": torch.empty(c, device="meta")}
    x = torch.empty(1, 4, c, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="C <="):
        wide_block_checks("t", x, blk, 1)
    assert wide_block_checks("t", x.float(), blk, 1)[-1] == "tile8x8"
    # Kernel I takes the 8x8-tile kernel above the tensor-core path's width
    xl = torch.empty(1, 4, 8, c, dtype=torch.bfloat16, device="meta")
    assert wide_block_checks("t", xl, blk, 0)[-1] == "tile8x8"


@pytest.mark.parametrize("c", [37, 144, 300])
def test_padded_w2t_rounds_once_and_pads_with_zeros(c):
    w2 = torch.randn(c, c, generator=torch.Generator().manual_seed(c))
    p = padded_w2t(w2)
    assert p.dtype == torch.bfloat16 and p.shape[0] % W2_ROWS == 0 and p.shape[1] % W2_COLS == 0
    assert p.shape[0] >= c and p.shape[1] >= c and p.shape[0] - c < W2_ROWS and p.shape[1] - c < W2_COLS
    assert torch.equal(p[:c, :c], w2.T.to(torch.bfloat16))
    assert not p[c:].any() and not p[:, c:].any()


def test_block_w2t_is_made_once_and_remade_when_w2_changes():
    blk = _block(40)
    first = block_w2t(blk)
    assert block_w2t(blk) is first and torch.equal(first, padded_w2t(blk["w2"]))
    blk["w2"].mul_(2.0)  # written in place: the version counter moves
    second = block_w2t(blk)
    assert second is not first and torch.equal(second, padded_w2t(blk["w2"]))
    blk["w2"] = blk["w2"].clone()  # another tensor with the same values
    assert block_w2t(blk) is not second
