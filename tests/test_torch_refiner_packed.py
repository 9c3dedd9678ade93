"""Kernel H's plain version (roma_tpu_torch.ops.fused_refiner_stack_packed
on CPU tensors) against the JAX package's packed channel-major refiner kernel
in interpret mode, at the three cases of tests/test_pallas_refiner.py's
test_packed_cmajor_bitexact_vs_cmajor, on the same folded blocks; and
Kernel H's argument contract with the body it picks, and its stacked
weights kept beside the blocks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import pallas_refiner as pr
from roma_tpu_torch.ops import fused_refiner_stack_packed
from roma_tpu_torch.ops.refiner_stack import PACKED_PATH_CODES, packed_checks, packed_weights
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)


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


# Kernel H's argument contract (ops.refiner_stack.packed_checks), a pure
# function: it runs on CPU tensors here as it runs before every launch
def _tblocks(c, n, k=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    return [dict(dw=f(k, k, c), db=f(c), w2=f(c, c), b2=f(c)) for _ in range(n)]


@pytest.mark.parametrize("c,k,dtype,path,group", [(24, 5, "bfloat16", "c24k5", 2), (24, 5, "float32", "generic", 2),
                                                   (24, 3, "bfloat16", "generic", 3), (16, 5, "bfloat16", "generic", 3),
                                                   (9, 7, "float32", "generic", 2), (32, 1, "bfloat16", "generic", 3)])
def test_packed_checks_pick_the_path(c, k, dtype, path, group):
    x = torch.zeros(2, 7, 9, c, dtype=getattr(torch, dtype))
    assert packed_checks("t", x, _tblocks(c, 3, k)) == (2, 7, 9, c, k, path, group)
    assert PACKED_PATH_CODES[path] in (0, 1)


def test_packed_checks_refuse_strided_x():
    x = torch.zeros(1, 8, 6, 24, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        packed_checks("t", x, _tblocks(24, 2))


@pytest.mark.parametrize("dtype,align", [("bfloat16", 16), ("float32", 1)])
def test_packed_checks_refuse_a_misaligned_base_on_the_vector_path(dtype, align):
    """The c24k5 body loads x by 16-byte vectors; the generic body (float32
    here) loads elements and takes any base."""
    dt = getattr(torch, dtype)
    n = 6 * 7 * 24
    flat = torch.zeros(n + 16, dtype=dt)
    first = next(off for off in range(16) if flat[off:].data_ptr() % 16 == 0)
    view = flat[first + 1:first + 1 + n].view(1, 6, 7, 24)
    if align == 16:
        with pytest.raises(ValueError, match="16-byte aligned"):
            packed_checks("t", view, _tblocks(24, 2))
        assert packed_checks("t", flat[first:first + n].view(1, 6, 7, 24), _tblocks(24, 2))[-2] == "c24k5"
    else:
        assert packed_checks("t", view, _tblocks(24, 2))[-2] == "generic"


def test_packed_checks_refuse_bad_blocks():
    x = torch.zeros(1, 6, 7, 24, dtype=torch.bfloat16)
    other = _tblocks(24, 1) + _tblocks(24, 1, k=3)  # a block of another K
    with pytest.raises(ValueError, match="folded block 1"):
        packed_checks("t", x, other)
    wide = _tblocks(24, 2)
    wide[1]["w2"] = torch.zeros(24, 25)  # a block of another shape
    with pytest.raises(ValueError, match="folded block 1"):
        packed_checks("t", x, wide)
    with pytest.raises(ValueError, match="folded block 0"):
        packed_checks("t", x, [{n: t.double() for n, t in blk.items()} for blk in _tblocks(24, 2)])
    with pytest.raises(ValueError, match="K=4"):
        packed_checks("t", x, _tblocks(24, 1, k=4))
    with pytest.raises(ValueError, match="outside"):
        packed_checks("t", torch.zeros(1, 6, 7, 33, dtype=torch.bfloat16), _tblocks(33, 1))
    with pytest.raises(TypeError):
        packed_checks("t", x.half(), _tblocks(24, 1))
    strided = _tblocks(24, 1)
    strided[0]["w2"] = strided[0]["w2"].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        packed_checks("t", x, strided)


def test_packed_checks_refuse_a_gradient():
    x = torch.zeros(1, 6, 7, 24, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        packed_checks("t", x, _tblocks(24, 1))
    with torch.no_grad():
        assert packed_checks("t", x, _tblocks(24, 1))[-2] == "generic"


def test_packed_weights_are_made_once_and_remade_when_a_source_changes():
    blocks = _tblocks(24, 3)
    first = packed_weights(blocks)
    assert packed_weights(blocks) is first
    for t, name in zip(first, ("dw", "db", "w2", "b2")):
        assert torch.equal(t, torch.stack([blk[name] for blk in blocks]))
    blocks[2]["w2"].add_(1.0)  # written in place: the version counter moves
    second = packed_weights(blocks)
    assert second is not first and torch.equal(second[2][2], blocks[2]["w2"])
    blocks[1]["db"] = blocks[1]["db"].clone()  # another tensor with the same values
    third = packed_weights(blocks)
    assert third is not second and torch.equal(third[1], second[1])
    assert packed_weights(blocks[:2]) is not third  # another list of blocks
