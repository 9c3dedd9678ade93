"""The port's v1 windowed sampler (roma_tpu_torch.graveyard.window_warp_v1,
plain paths on the CPU) against the JAX package's graveyard v1 sampler in
interpret mode, at the five cases of tests/test_ops.py's
test_windowed_grid_sample_matches_plain, and against the port's grid_sample."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graveyard import window_warp_v1 as jv1
from roma_tpu_torch.graveyard.window_warp_v1 import WindowSpec, windowed_grid_sample
from roma_tpu_torch.ops import grid_sample, warp_tiles_v1


@pytest.mark.parametrize(
    "name,shape,warp_sigma,wild_frac,fixup_k,branch",
    [
        ("smooth", (2, 32, 48, 6, 32, 48), 0.01, 0.0, 64, None),
        ("wild-2pct", (2, 32, 32, 4, 32, 32), 0.02, 0.02, 64, None),
        ("overflow-fallback", (1, 32, 32, 4, 32, 32), 0.02, 0.5, 16, "exact"),
        ("nonmult-tiles", (1, 36, 44, 5, 28, 36), 0.02, 0.0, 64, None),
        ("tiny-img", (1, 12, 12, 3, 20, 20), 0.1, 0.0, 64, "small_image"),
    ],
)
def test_windowed_grid_sample_matches_jax(name, shape, warp_sigma, wild_frac, fixup_k, branch):
    rs = np.random.RandomState(0)
    spec = dict(th=8, tw=8, wh=24, ww=40, xq=8, pm=8, kf=fixup_k)
    b, h, w, c, hq, wq = shape
    x = rs.randn(b, h, w, c).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, hq), np.linspace(-1, 1, wq), indexing="ij")
    g = np.stack([gx, gy], -1)[None].repeat(b, 0) + warp_sigma * rs.randn(b, hq, wq, 2)
    if wild_frac:
        m = rs.rand(b, hq, wq) < wild_frac
        g[m] = rs.uniform(-2.5, 2.5, (int(m.sum()), 2))
    g = g.astype(np.float32)
    ref = np.asarray(jv1.windowed_grid_sample(jnp.asarray(x), jnp.asarray(g), spec=jv1.WindowSpec(**spec),
                                              interpret=True))
    before = dict(windowed_grid_sample.branches)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = windowed_grid_sample(tx, tg, WindowSpec(**spec)).numpy()
    assert got.shape == (b, hq, wq, c)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, grid_sample(tx, tg).numpy(), atol=1e-5)
    moved = {k: v - before[k] for k, v in windowed_grid_sample.branches.items()}
    assert moved == {k: int(k == branch) for k in moved}
    assert warp_tiles_v1.launches == 0
