"""Kernel C's plain version (roma_tpu_torch.ops.warp_sample) against the JAX
package's lane-packed Pallas sampler in interpret mode, and its argument
contract with the path it picks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops.lane_warp import LaneSpec, lane_warp
from roma_tpu_torch.ops import warp_sample
from roma_tpu_torch.ops.warp_sample import warp_sample_checks
from torch_port_fixtures import flow_field

SPEC = LaneSpec(th=8, tw=8, wh=16, xq=8, ns=3, pm=8, kf=8, nt_bad=4)
WIDE_SPEC = LaneSpec(th=8, tw=8, wh=16, xq=2, ns=8, pm=8, kf=8, nt_bad=4)


@pytest.mark.parametrize("kind", ["smooth", "offimage", "speckle", "wild"])
@pytest.mark.parametrize("c", [9, 64])
def test_warp_sample_matches_lane_warp(kind, c):
    h = w = 40
    rs = np.random.RandomState(1)
    x = rs.randn(2, h, w, c).astype(np.float32)
    flow = flow_field(h, w, 2, kind)
    spec = SPEC if c <= 16 else WIDE_SPEC
    ref = np.asarray(lane_warp(jnp.asarray(x), jnp.asarray(flow), spec=spec, interpret=True))
    got = warp_sample(torch.from_numpy(x), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("c", [9, 64])
def test_warp_sample_rectangular_mismatched_grid(c):
    """Query grid of another size than the rectangular feature map."""
    h, w, hq, wq = 48, 56, 30, 26
    rs = np.random.RandomState(4)
    x = rs.randn(2, h, w, c).astype(np.float32)
    flow = flow_field(hq, wq, 2, "smooth", seed=5)
    spec = SPEC if c <= 16 else WIDE_SPEC
    ref = np.asarray(lane_warp(jnp.asarray(x), jnp.asarray(flow), spec=spec, interpret=True))
    got = warp_sample(torch.from_numpy(x), torch.from_numpy(flow)).numpy()
    assert got.shape == (2, hq, wq, c)
    np.testing.assert_allclose(got, ref, atol=1e-5)


# Kernel C's argument contract (ops.warp_sample.warp_sample_checks), a pure
# function: it runs on CPU tensors here as it runs before every launch
PATHS = [("bfloat16", 9, "registers"), ("bfloat16", 16, "vector"), ("bfloat16", 64, "vector"),
         ("bfloat16", 512, "vector"), ("bfloat16", 37, "scalar"), ("bfloat16", 6, "scalar"),
         ("float32", 9, "registers"), ("float32", 16, "vector"), ("float32", 64, "vector"),
         ("float32", 512, "vector"), ("float32", 37, "scalar"), ("float32", 3, "registers")]


@pytest.mark.parametrize("dtype,c,path", PATHS)
def test_checks_pick_the_path(dtype, c, path):
    y = torch.zeros(2, 7, 9, c, dtype=getattr(torch, dtype))
    flow = torch.zeros(2, 5, 6, 2)
    assert warp_sample_checks("t", y, flow) == (2, 7, 9, c, 5, 6, path)


def test_checks_refuse_strided_views():
    y, flow = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16), torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        warp_sample_checks("t", y.transpose(1, 2), flow)
    with pytest.raises(ValueError, match="contiguous"):
        warp_sample_checks("t", y, torch.zeros(1, 8, 2, 8).transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        warp_sample_checks("t", y[..., ::2], flow)


@pytest.mark.parametrize("c,ok_offset", [(64, 8), (9, 2), (37, None)])
def test_checks_refuse_a_misaligned_base(c, ok_offset):
    """The vector path needs y's base on 16 bytes, the registers path on a
    pair of elements; the scalar path takes any base."""
    flat = torch.zeros(8 * 8 * c + 16, dtype=torch.bfloat16)
    flow = torch.zeros(1, 4, 4, 2)
    view = lambda off: flat[off:off + 8 * 8 * c].view(1, 8, 8, c)  # noqa: E731
    first = next(off for off in range(8) if view(off).data_ptr() % 16 == 0)
    warp_sample_checks("t", view(first), flow)
    if ok_offset is None:
        warp_sample_checks("t", view(first + 1), flow)
        return
    with pytest.raises(ValueError, match="aligned"):
        warp_sample_checks("t", view(first + 1), flow)
    warp_sample_checks("t", view(first + ok_offset), flow)


def test_checks_refuse_bad_arguments():
    y = torch.zeros(2, 8, 8, 9)
    with pytest.raises(TypeError):
        warp_sample_checks("t", y.half(), torch.zeros(2, 4, 4, 2))
    for flow in (torch.zeros(2, 4, 4, 2, dtype=torch.float64), torch.zeros(1, 4, 4, 2), torch.zeros(2, 4, 4, 3)):
        with pytest.raises(ValueError, match="flow"):
            warp_sample_checks("t", y, flow)
    with pytest.raises(ValueError, match="H, W, C >= 1"):
        warp_sample_checks("t", torch.zeros(2, 0, 8, 9), torch.zeros(2, 4, 4, 2))


def test_checks_refuse_sizes_past_32_bit_indexing():
    """Shapes only (meta tensors): y or the output at 2^31 elements."""
    y = torch.empty(2, 1024, 1024, 1024, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        warp_sample_checks("t", y, torch.empty(2, 4, 4, 2, device="meta"))
    y = torch.empty(2, 8, 8, 512, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        warp_sample_checks("t", y, torch.empty(2, 1024, 2048, 2, device="meta"))
