"""The port matcher's remaining API against the JAX matcher at
RoMaConfig.tiny(), on the same numpy inputs: match_keypoints (indices and
keypoints exactly equal, on keypoints whose distances have no near ties),
conf_from_fb_consistency and visualize_warp (maps to atol 1e-5 in float32;
images written under tmp_path)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_fixtures import TINY as JAX_TINY
from torch_port_fixtures import seeded_tiny_variables

from roma_tpu.models.roma import RegressionMatcher as JaxMatcher
from roma_tpu_torch import ops
from roma_tpu_torch.models import RoMaConfig, roma_outdoor
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

H, W = 32, 40


@pytest.fixture(scope="module")
def matchers():
    jm = JaxMatcher(seeded_tiny_variables(0), h=56, w=56, upsample_res=(64, 64), config=JAX_TINY)
    tm = roma_outdoor(device="cpu", amp=False, coarse_res=56, upsample_res=64, config=RoMaConfig.tiny())
    return jm, tm


def smooth_warp(rs, symmetric=True):
    """(H, 2W or W, 4) float32: each half the identity on its own side and a
    smooth displacement into the other, a few pixels off the image."""
    gy, gx = np.meshgrid(np.linspace(-1 + 1 / H, 1 - 1 / H, H), np.linspace(-1 + 1 / W, 1 - 1 / W, W),
                         indexing="ij")
    grid = np.stack([gx, gy], -1)
    halves = []
    for _ in range(2 if symmetric else 1):
        disp = 0.08 * np.stack([np.sin(3 * gy + rs.rand()), np.cos(2 * gx + rs.rand())], -1)
        halves.append(np.concatenate([grid, grid + disp], -1))
    if symmetric:
        halves[1] = halves[1][..., [2, 3, 0, 1]]
    return np.concatenate(halves, 1).astype(np.float32)


def keypoints(rs, warp, n=60):
    """x_A uniform in the image; x_B: 40 of the points the warp sends x_A to
    (the port's grid_sample), each moved ~1e-3, and 20 uniform points."""
    x_a = rs.uniform(-0.95, 0.95, (n, 2)).astype(np.float32)
    a2b = ops.grid_sample(torch.from_numpy(warp)[None, ..., -2:], torch.from_numpy(x_a)[None, None])[0, 0].numpy()
    pick = rs.permutation(n)[:40]
    x_b = np.concatenate([a2b[pick] + 1e-3 * rs.randn(40, 2), rs.uniform(-0.95, 0.95, (20, 2))])
    return x_a, x_b[rs.permutation(60)].astype(np.float32)


@pytest.mark.parametrize("return_tuple,return_inds,cert_th", [(True, False, 0), (True, True, 0), (False, False, 0),
                                                              (False, True, 0), (True, True, 0.4)])
def test_match_keypoints_matches_jax(matchers, return_tuple, return_inds, cert_th):
    jm, tm = matchers
    rs = np.random.RandomState(1)
    warp = smooth_warp(rs)
    cert = rs.uniform(0, 1, (H, 2 * W)).astype(np.float32)
    x_a, x_b = keypoints(rs, warp)
    kw = dict(return_tuple=return_tuple, return_inds=return_inds, cert_th=cert_th)
    want = jm.match_keypoints(x_a, x_b, warp, cert, **kw)
    got = tm.match_keypoints(torch.from_numpy(x_a), x_b, torch.from_numpy(warp), cert, **kw)
    for g, w in zip(got, want) if return_tuple else ((got, want),):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    n = len(want[0]) if return_tuple else len(want) // (2 if return_inds else 1)
    assert n > (10 if cert_th else 25)  # most of the 40 planted pairs are found


@pytest.mark.parametrize("batched", [False, True])
def test_conf_from_fb_consistency_matches_jax(matchers, batched):
    jm, tm = matchers
    rs = np.random.RandomState(2)
    warp = smooth_warp(rs)
    ff, fb = warp[:, :W, 2:], warp[:, W:, 2:]
    fb = fb.copy()
    fb[:8, :10] += 0.5  # an inconsistent patch
    if batched:
        ff, fb = np.stack([ff, ff[::-1]]), np.stack([fb, fb])
    want = np.asarray(jm.conf_from_fb_consistency(ff, fb))
    got = tm.conf_from_fb_consistency(torch.from_numpy(ff), torch.from_numpy(fb))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert 0 < want.mean() < 1


@pytest.fixture(scope="module")
def image_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("match_api")
    rs = np.random.RandomState(3)
    paths = []
    for name, hw in (("a.png", (45, 60)), ("b.png", (50, 38))):
        Image.fromarray((rs.rand(*hw, 3) * 255).astype(np.uint8)).save(d / name)
        paths.append(str(d / name))
    return paths


@pytest.mark.parametrize("symmetric", [True, False])
def test_visualize_warp_matches_jax(matchers, image_paths, tmp_path, symmetric):
    jm, tm = matchers
    rs = np.random.RandomState(4)
    warp = smooth_warp(rs, symmetric)
    cert = rs.uniform(0, 1, warp.shape[:2]).astype(np.float32)
    want = np.asarray(jm.visualize_warp(warp, cert, *image_paths, symmetric=symmetric,
                                        save_path=str(tmp_path / "jax.png")))
    im_b = Image.open(image_paths[1])
    got = tm.visualize_warp(torch.from_numpy(warp), torch.from_numpy(cert), image_paths[0], im_b,
                            symmetric=symmetric, save_path=str(tmp_path / "port.png"))
    assert tuple(got.shape) == want.shape == (H, warp.shape[1], 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    saved = [np.asarray(Image.open(tmp_path / f"{n}.png")).astype(int) for n in ("jax", "port")]
    assert saved[0].shape == saved[1].shape and np.abs(saved[0] - saved[1]).max() <= 1
