"""The port's Tiny RoMa (roma_tpu_torch.models.xfeat / tiny) against the JAX
package's, float32 on the CPU, at 64 x 96 and 70 x 90 like tests/test_tiny.py.

The same JAX variables (tests/torch_port_fixtures.py, He-scaled from a numpy
seed) go through JAX and, by the bridge of models/convert.py, through the
port. The bars are the JAX package's own against its torch spec: XFeat
atol 2e-4, rtol 1e-3; the net, exact and approximate, equal and unequal
sizes, and ``match``'s warp and certainty atol 5e-4, rtol 1e-3. The
approximate path's argmax is pinned: each test asserts that every A cell's
best correlation leads its runner-up by far more than float32 noise
(``ARGMAX_GAP``), so no near-tie can flip it between the two sides.
``sample`` in each mode equals JAX's on JAX's uniforms
(tests/test_torch_sampling_uniforms.py); ``to_pixel_coordinates`` and
``visualize_warp`` (with and without ``symmetric``) equal JAX's."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from roma_tpu.models.tiny import TinyRoMa as JaxTinyRoMa
from roma_tpu.models.tiny import TinyRoMaNet as JaxTinyRoMaNet
from roma_tpu.models.tiny import corr_volume_qmajor as jax_corr
from roma_tpu.models.tiny import resize_pil as jax_resize_pil
from roma_tpu.models.xfeat import XFeatBackbone as JaxXFeat
from roma_tpu.models.zoo import convert as jconvert
from roma_tpu_torch import TinyRoMa, TinyRoMaNet
from roma_tpu_torch.models.convert import check_jax_shapes, to_port_layout
from roma_tpu_torch.models.tiny import corr_volume_qmajor, resize_pil
from roma_tpu_torch.models.zoo.convert import XFEAT_PREFIX, to_reference
from roma_tpu_torch.ops import KERNEL_WRAPPERS, interpolate
from test_torch_sampling_uniforms import DRAW_DIFF, feed, uniforms
from torch_port_fixtures import port_tiny_net, seeded_tiny_roma_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

XFEAT_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(atol=5e-4, rtol=1e-3)
ARGMAX_GAP = 1e-3


@pytest.fixture(scope="module")
def variables():
    return seeded_tiny_roma_variables(0)


@pytest.fixture(scope="module")
def net(variables):
    return port_tiny_net(variables).eval()


def images(b, h, w, seed):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def assert_argmax_pinned(net, im_a, im_b):
    """Every A cell's best B cell leads the runner-up by ARGMAX_GAP, the
    images resized to their /32 grids as ``match`` does."""
    with torch.no_grad():
        x_a, x_b = (torch.from_numpy(x) for x in (im_a, im_b))
        _, f_a = net.xfeat(interpolate(x_a, TinyRoMa._proc_hw(x_a)))
        _, f_b = net.xfeat(interpolate(x_b, TinyRoMa._proc_hw(x_b)))
        top2 = corr_volume_qmajor(f_a, f_b).topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    assert gap > ARGMAX_GAP, gap


def test_bridge_writes_every_tensor_once_and_inverts_the_jax_converter(variables, net):
    """Every port tensor has one JAX leaf; the port's tensors written out in
    the reference layout and read by the JAX converter give back the JAX
    variables leaf for leaf."""
    n = len([k for k in net.state_dict() if not k.endswith("num_batches_tracked")])
    assert check_jax_shapes(variables, TinyRoMaNet()) == n == 3 * 18 + 4 + 2 * (3 * 4 + 2)  # XFeat, matchers
    tiny_sd, xfeat_sd = to_reference(net, XFEAT_PREFIX)
    assert sorted({k.split(".")[0] for k in tiny_sd}) == ["coarse_matcher", "fine_matcher"]
    back = jconvert.convert_tiny_roma(jconvert.state_dict_to_numpy(tiny_sd), jconvert.state_dict_to_numpy(xfeat_sd))
    want, got = to_port_layout(variables), to_port_layout(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_xfeat_matches_jax(variables, net):
    im = images(2, 64, 96, 0)
    j_fine, j_coarse = JaxXFeat().apply({"params": variables["params"]["xfeat"],
                                         "batch_stats": variables["batch_stats"]["xfeat"]}, jnp.asarray(im))
    with torch.no_grad():
        t_fine, t_coarse = net.xfeat(torch.from_numpy(im))
    assert t_fine.shape == (2, 16, 24, 24) and t_coarse.shape == (2, 8, 12, 64)
    np.testing.assert_allclose(t_fine.numpy(), np.asarray(j_fine), **XFEAT_TOL)
    np.testing.assert_allclose(t_coarse.numpy(), np.asarray(j_coarse), **XFEAT_TOL)
    assert np.abs(np.asarray(j_coarse)).mean() > 0.1  # not a flat map


def test_corr_volume_matches_jax():
    rs = np.random.RandomState(1)
    f0, f1 = rs.randn(2, 8, 12, 64).astype(np.float32), rs.randn(2, 12, 8, 64).astype(np.float32)
    got = corr_volume_qmajor(torch.from_numpy(f0), torch.from_numpy(f1))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_corr(jnp.asarray(f0), jnp.asarray(f1))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shapes", [((64, 96), (64, 96)), ((64, 96), (96, 64))], ids=["equal", "unequal"])
def test_forward_matches_jax(variables, net, exact, shapes):
    im_a, im_b = images(1, *shapes[0], 1), images(1, *shapes[1], 2)
    if not exact:
        assert_argmax_pinned(net, im_a, im_b)
    corr = JaxTinyRoMaNet(exact_softmax=exact).apply(variables, jnp.asarray(im_a), jnp.asarray(im_b))
    t_net = port_tiny_net(variables, exact_softmax=exact).eval()
    with torch.no_grad():
        got = t_net(torch.from_numpy(im_a), torch.from_numpy(im_b))
    assert sorted(got) == [4, 8] and all(sorted(got[s]) == ["certainty", "flow"] for s in got)
    assert got[4]["flow"].shape[1:3] == (16, 24)  # A's grid
    for s in (8, 4):
        for k in ("flow", "certainty"):
            np.testing.assert_allclose(got[s][k].numpy(), np.asarray(corr[s][k]), **TOL, err_msg=f"{s} {k}")
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)


@pytest.fixture(scope="module")
def matchers(variables, net):
    return JaxTinyRoMa(variables), TinyRoMa(net)


def _assert_match(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


def test_match_arrays_batched_and_not(matchers, net):
    jm, tm = matchers
    a, b = images(2, 70, 90, 3), images(2, 70, 90, 4)  # not /32: resized to 64 x 64 inside
    assert_argmax_pinned(net, a, b)
    got = tm.match(a, b)
    assert got[0].shape == (2, 70, 90, 4) and got[1].shape == (2, 70, 90)
    _assert_match(got, jm.match(a, b))
    one = tm.match(a[0], b[0])
    assert one[0].shape == (70, 90, 4)
    _assert_match(one, (got[0][0], got[1][0]))
    _assert_match(tm.match(torch.from_numpy(a), torch.from_numpy(b), batched=False), (got[0][0], got[1][0]))


def test_match_unequal_sizes_keeps_each_grid(matchers, net):
    jm, tm = matchers
    a, b = images(1, 70, 120, 5)[0], images(1, 120, 70, 6)[0]
    assert_argmax_pinned(net, a[None], b[None])
    got = tm.match(a, b)
    assert got[0].shape == (70, 120, 4)
    _assert_match(got, jm.match(a, b))


def test_match_paths_and_pil_images(matchers, tmp_path):
    jm, tm = matchers
    paths = []
    for i, (h, w) in enumerate(((72, 100), (80, 90))):
        p = tmp_path / f"im{i}.png"
        Image.fromarray((images(1, h, w, 10 + i)[0] * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    got = tm.match(*paths)
    assert got[0].shape == (72, 100, 4) and got[1].shape == (72, 100)
    _assert_match(got, jm.match(*paths))
    pil = [Image.open(p) for p in paths]
    _assert_match(tm.match(*pil), got)


def test_forward_takes_a_batch_dict(matchers, variables):
    jm, tm = matchers
    batch = {"im_A": images(1, 64, 70, 7), "im_B": images(1, 64, 70, 8)}
    got, want = tm.forward(batch), jm.forward(batch)
    np.testing.assert_allclose(got[4]["flow"].numpy(), np.asarray(want[4]["flow"]), **TOL)


def test_bf16_runs_under_autocast_over_float32_parameters(variables):
    """bf16 against float32 on the exact softmax (the approximate one's
    argmax may flip under bf16 features): within a few bf16 roundings."""
    net = port_tiny_net(variables, exact_softmax=True).eval()
    a, b = images(1, 64, 64, 9), images(1, 64, 64, 10)
    warp, cert = TinyRoMa(net, dtype=torch.bfloat16).match(a, b)
    ref_warp, ref_cert = TinyRoMa(net).match(a, b)
    assert warp.dtype == torch.float32 and torch.isfinite(warp).all() and torch.isfinite(cert).all()
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert (warp - ref_warp).abs().max() < 0.05 and (cert - ref_cert).abs().max() < 0.05


@pytest.mark.parametrize("mode", ["threshold_balanced", "balanced", "threshold", "sample"])
def test_sample_modes_equal_jax_on_its_uniforms(matchers, mode, monkeypatch):
    jm, tm = matchers
    warp, cert = tm.match(images(1, 64, 96, 11)[0], images(1, 64, 96, 12)[0])
    cert = cert * (torch.arange(cert.numel()).reshape(cert.shape) % 3 > 0)  # some below the threshold
    num, n = 500, cert.numel()
    jm.sample_mode = tm.sample_mode = mode
    key = jax.random.PRNGKey(4)
    j_m, j_c = jm.sample(warp.numpy(), cert.numpy(), num=num, key=key)
    us = uniforms(key, (n,), (min(4 * num, n),)) if "balanced" in mode else uniforms(key, (n,))
    feed(monkeypatch, us)
    t_m, t_c = tm.sample(warp, cert, num=num)
    monkeypatch.undo()
    assert t_m.shape == (num, 4) and t_c.shape == (num,) and t_m.abs().max() <= 1
    rows = lambda m: {tuple(r) for r in np.asarray(m).tolist()}
    assert 1 - len(rows(t_m) & rows(j_m)) / num <= DRAW_DIFF
    if "threshold" in mode:
        assert set(np.unique(t_c.numpy())) <= set(np.unique(np.where(cert > 0.05, 1.0, cert)))
    # a key of its own: the same draw each time, the instance's stream untouched
    assert torch.equal(tm.sample(warp, cert, num=num, key=3)[0], tm.sample(warp, cert, num=num, key=3)[0])
    with pytest.raises(ValueError):
        tm.sample(warp, cert, key=1, generator=torch.Generator())


def test_to_pixel_coordinates_match_jax(matchers):
    jm, tm = matchers
    m = np.random.RandomState(2).uniform(-1, 1, (50, 4)).astype(np.float32)
    for got, want in zip(tm.to_pixel_coordinates(m, 70, 90, 120, 80), jm.to_pixel_coordinates(m, 70, 90, 120, 80)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(tm.to_pixel_coordinates(m[:, :2], 70, 90).numpy(),
                               np.asarray(jm.to_pixel_coordinates(m[:, :2], 70, 90)), rtol=1e-6)


@pytest.mark.parametrize("symmetric", [False, True])
def test_visualize_warp_matches_jax(matchers, symmetric, tmp_path):
    jm, tm = matchers
    a, b = images(1, 64, 96, 13)[0], images(1, 64, 96, 14)[0]
    warp, cert = tm.match(a, b)
    if symmetric:
        back, cert_b = tm.match(b, a)
        warp = torch.cat((warp, back[..., [2, 3, 0, 1]]), dim=1)
        cert = torch.cat((cert, cert_b), dim=1)
    path = tmp_path / "vis.png"
    got = tm.visualize_warp(warp, cert, a, b, save_path=path, symmetric=symmetric)
    want = jm.visualize_warp(warp.numpy(), cert.numpy(), a, b, symmetric=symmetric)
    assert got.shape == (64, 192 if symmetric else 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert np.asarray(Image.open(path)).shape == tuple(got.shape)


def test_resize_pil_matches_jax():
    im = images(1, 50, 70, 15)[0]
    np.testing.assert_array_equal(np.asarray(resize_pil(im, (32, 48))), np.asarray(jax_resize_pil(im, (32, 48))))
