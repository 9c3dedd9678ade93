"""The port's v2 windowed sampler (roma_tpu_torch.ops.windowed_warp, plain
paths on the CPU) against the JAX package's windowed_warp in interpret mode
and against the port's grid_sample, at the cases of tests/test_tile_window.py;
the plan's integer fields against JAX's; the branch counters."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import tile_window as jtw
from roma_tpu_torch.ops import WarpSpec, grid_sample, warp_tiles, windowed_warp
from roma_tpu_torch.ops.tile_window import _plan, _tile_args, tile_checks

SPEC = dict(th=8, tw=8, wh=16, xq=8, ns=3, pm=4, kf=8, nt_bad=4)
KINDS = ["smooth", "offimage", "speckle", "wild"]


def _flow(h, w, b, kind, seed=0):
    rs = np.random.RandomState(seed)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    f = np.stack([gx, gy], -1)[None].repeat(b, 0)
    if kind == "smooth":
        f = f + 0.05 * rs.randn(b, h, w, 2)
    elif kind == "offimage":
        f = f + 0.05 * rs.randn(b, h, w, 2)
        f[:, : h // 3] -= 3.0  # top band fully out of image
    elif kind == "speckle":
        f = f + 0.03 * rs.randn(b, h, w, 2)
        sp = rs.rand(b, h, w) < 0.05
        f[..., 0] += np.where(sp, rs.randn(b, h, w), 0.0)
        f[..., 1] += np.where(sp, rs.randn(b, h, w), 0.0)
    elif kind == "wild":
        f = 2.5 * rs.randn(b, h, w, 2)  # scattered, most of it far off the image
    return f.astype(np.float32)


def _both(x, flow, **spec):
    """(JAX interpret-mode result, port result, port's grid_sample) as f32."""
    ref = jtw.windowed_warp(jnp.asarray(x), jnp.asarray(flow), spec=jtw.WarpSpec(**spec), interpret=True)
    tx, tf = torch.from_numpy(np.asarray(x)), torch.from_numpy(flow)
    got = windowed_warp(tx, tf, WarpSpec(**spec))
    return np.asarray(ref, np.float32), got.float().numpy(), grid_sample(tx, tf).float().numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_plan_integer_fields_match_jax(kind):
    h = w = 40
    flow = _flow(h, w, 2, kind, seed=3)
    ref = jtw._plan(jnp.asarray(flow), h, w, jtw.WarpSpec(**SPEC))
    got = _plan(torch.from_numpy(flow), h, w, WarpSpec(**SPEC))
    for k in ("oy", "jx", "yl", "xl", "needfix", "counts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dots", ["f32", "bf16x2"])
def test_windowed_warp_matches_jax(kind, dots):
    h = w = 40
    b, c = 2, 5
    x = np.random.RandomState(1).randn(b, h, w, c).astype(np.float32)
    flow = _flow(h, w, b, kind)
    before = dict(windowed_warp.branches)
    ref, got, plain = _both(x, flow, **SPEC, dots=dots)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    # the branch JAX's lax.cond takes: the exact one when more than nt_bad
    # tiles overflow (here "offimage": 10 of 50 tiles; "wild" sends most
    # queries wholly off the image, which need no fixup: 4 tiles, recomputed)
    counts = np.asarray(jtw._plan(jnp.asarray(flow), h, w, jtw.WarpSpec(**SPEC))["counts"]).ravel()
    n_over = int((counts > SPEC["kf"]).sum())
    exact = n_over > max(SPEC["nt_bad"], counts.size // 24)
    assert exact == (kind == "offimage")
    assert windowed_warp.branches["exact"] - before["exact"] == exact
    assert windowed_warp.branches["tile_recompute"] - before["tile_recompute"] == (0 if exact else n_over)
    assert windowed_warp.branches["small_image"] == before["small_image"]
    assert warp_tiles.launches == 0


@pytest.mark.parametrize("kind", ["offimage", "speckle"])
def test_windowed_warp_bf16(kind):
    """bf16 I/O: the exact branch ("offimage") and the tile path with its
    fixups added in f32 before the one rounding ("speckle")."""
    h = w = 40
    b, c = 2, 9
    x = jnp.asarray(np.random.RandomState(2).randn(b, h, w, c), jnp.bfloat16)
    flow = _flow(h, w, b, kind, seed=3)
    ref = np.asarray(jtw.windowed_warp(x, jnp.asarray(flow), spec=jtw.WarpSpec(**SPEC), interpret=True),
                     np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = windowed_warp(tx, torch.from_numpy(flow), WarpSpec(**SPEC))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), grid_sample(tx, torch.from_numpy(flow)).float().numpy(),
                               atol=2e-2)


def test_windowed_warp_rectangular_and_mismatched_grid():
    """A query grid of another size than the feature map, with partial tiles."""
    b, c, h, w = 2, 4, 48, 56
    x = np.random.RandomState(4).randn(b, h, w, c).astype(np.float32)
    ref, got, plain = _both(x, _flow(30, 26, b, "smooth", seed=5), **SPEC)
    assert got.shape == (b, 30, 26, c)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)


def test_windowed_warp_small_image_branch():
    b, c, h, w = 1, 3, 10, 10
    x = np.random.RandomState(6).randn(b, h, w, c).astype(np.float32)
    before = windowed_warp.branches["small_image"]
    ref, got, plain = _both(x, _flow(h, w, b, "smooth", seed=7), **SPEC)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    assert windowed_warp.branches["small_image"] == before + 1


def _good_tile_args():
    b, c, h, w = 2, 5, 40, 40
    x = torch.from_numpy(np.random.RandomState(8).randn(b, h, w, c).astype(np.float32))
    spec = WarpSpec(**SPEC)
    return list(_tile_args(x, _plan(torch.from_numpy(_flow(h, w, b, "speckle", seed=9)), h, w, spec), spec))


BAD_TILE_ARGS = {
    "yl int64": (1, lambda a: a.long(), ValueError),
    "fy short by a query": (3, lambda a: a[:, :-1].contiguous(), ValueError),
    "fx not contiguous": (4, lambda a: a.t().contiguous().t(), ValueError),
    "fval of another C": (8, lambda a: a[..., :-1].contiguous(), ValueError),
    "tiles not a whole number per image": (None, None, ValueError),
    "x requires grad": (0, lambda a: a.clone().requires_grad_(), RuntimeError),
}


@pytest.mark.parametrize("case", [None, *BAD_TILE_ARGS])
def test_tile_checks_hold_kernel_g_to_its_contract(case):
    """Kernel G's wrapper checks every argument in one pass before a launch
    (tile_checks, run here on CPU tensors): the plan's own arguments pass,
    each broken one raises."""
    args = _good_tile_args()
    if case is None:
        assert tile_checks("warp_tiles", *args[:9]) == (2, 40, 40, 5, args[1].shape[0], 64, SPEC["kf"])
        return
    i, change, err = BAD_TILE_ARGS[case]
    if i is None:  # one tile fewer: 49 tiles over 2 images
        args = [args[0]] + [a[1:] for a in args[1:9]] + args[9:]
    else:
        args[i] = change(args[i])
    with pytest.raises(err):
        tile_checks("warp_tiles", *args[:9])
