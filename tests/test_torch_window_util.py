"""Kernel F's plain version (roma_tpu_torch.ops.compact_miss) against the JAX
package's compaction kernel in interpret mode: exact equality of the slot
positions, sentinel T included; and the port's copy of _query_subblock."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import window_util as jwu
from roma_tpu_torch.ops import compact_miss
from roma_tpu_torch.ops.window_util import _query_subblock


@pytest.mark.parametrize("t,kf,density", [(64, 8, 0.0), (64, 8, 0.05), (256, 32, 0.05),
                                          (256, 32, 0.5), (256, 16, 1.0), (1024, 64, 0.02)])
def test_compact_miss_matches_pallas_interpret(t, kf, density):
    rs = np.random.RandomState(t + kf)
    miss = rs.rand(12, 1, t) < density
    ref = np.asarray(jwu._compact_miss(jnp.asarray(miss), t, kf, interpret=True))
    got = compact_miss(torch.from_numpy(miss), t, kf)
    assert got.dtype == torch.int32 and tuple(got.shape) == (12, kf, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert compact_miss.launches == 0


@pytest.mark.parametrize("t,cap", [(256, 1024), (4096, 1024), (1000, 512), (97, 32), (360, 100)])
def test_query_subblock_matches_jax(t, cap):
    assert _query_subblock(t, cap) == jwu._query_subblock(t, cap)
