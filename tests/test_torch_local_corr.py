"""Kernel B's plain version (roma_tpu_torch.ops.local_correlation) against
the JAX package: the windowed Pallas kernel in interpret mode at r in {1, 2},
the XLA patch / corrvol paths at r in {3, 7}."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops.local_corr import local_correlation as jax_local_corr
from roma_tpu.ops.tile_window import CorrSpec, windowed_local_corr
from roma_tpu_torch.ops import local_correlation
from torch_port_fixtures import flow_field

CSPEC = CorrSpec(th=8, tw=8, wh=24, xq=8, ns=4, pm=8, kf=4, nt_bad=8, cc=8)
ATOL = 1e-4  # C-long float32 dot products summed in another order


def _inputs(b, h, w, c, kind, seed):
    rs = np.random.RandomState(seed)
    f0 = rs.randn(b, h, w, c).astype(np.float32)
    f1 = rs.randn(b, h, w, c).astype(np.float32)
    return f0, f1, flow_field(h, w, b, kind, seed=seed)


def _port(f0, f1, r, flow):
    return local_correlation(torch.from_numpy(f0), torch.from_numpy(f1), r, torch.from_numpy(flow)).numpy()


@pytest.mark.parametrize("kind", ["smooth", "offimage", "speckle", "wild"])
@pytest.mark.parametrize("radius", [1, 2])
def test_local_corr_matches_windowed_interpret(kind, radius):
    f0, f1, flow = _inputs(2, 40, 40, 24, kind, radius)
    ref = windowed_local_corr(jnp.asarray(f0), jnp.asarray(f1), radius, jnp.asarray(flow),
                              spec=CSPEC, interpret=True)
    np.testing.assert_allclose(_port(f0, f1, radius, flow), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("radius,method", [(3, "patch"), (3, "corrvol"), (7, "corrvol"), (7, "patch")])
@pytest.mark.parametrize("kind", ["smooth", "offimage", "wild"])
def test_local_corr_matches_xla_paths(radius, method, kind):
    f0, f1, flow = _inputs(2, 20, 24, 32, kind, 10 + radius)
    ref = jax_local_corr(jnp.asarray(f0), jnp.asarray(f1), radius, jnp.asarray(flow), method=method)
    got = _port(f0, f1, radius, flow)
    assert got.shape == (2, 20, 24, (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
