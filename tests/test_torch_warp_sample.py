"""Kernel C's plain version (roma_tpu_torch.ops.warp_sample) against the JAX
package's lane-packed Pallas sampler in interpret mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops.lane_warp import LaneSpec, lane_warp
from roma_tpu_torch.ops import warp_sample
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
