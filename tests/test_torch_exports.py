"""The port's public names against the JAX package's: every name of
``roma_tpu.__all__``, ``roma_tpu.ops.__all__`` and ``roma_tpu.utils.__all__``
exists in the port's namespace of the same place, and each helper the port
added for them equals its JAX counterpart on seeded inputs on the CPU: the
coordinate maps (bit for bit; the matcher's methods are the same functions),
``corr_volume`` (atol 1e-5), ``check_not_i16``, ``check_rgb`` and ``prepare``
on image files written under tmp_path, ``attention_packed`` (the kernel
wrapper itself), and ``vit_large``'s layout on the meta device against JAX's
``vit_large`` under ``jax.eval_shape``, through models/convert.py's names."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import roma_tpu
import roma_tpu.ops as j_ops
import roma_tpu.utils as j_utils
import roma_tpu_torch
import roma_tpu_torch.ops as t_ops
import roma_tpu_torch.utils as t_utils
from roma_tpu.models.vit import vit_large as jax_vit_large
from roma_tpu_torch.models import RegressionMatcher
from roma_tpu_torch.models.convert import check_jax_shapes
from roma_tpu_torch.models.vit import vit_large
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)


@pytest.mark.parametrize("jax_pkg,port_pkg", [(roma_tpu, roma_tpu_torch), (j_ops, t_ops), (j_utils, t_utils)],
                         ids=["roma_tpu", "ops", "utils"])
def test_jax_names_are_exported_by_the_port(jax_pkg, port_pkg):
    assert set(jax_pkg.__all__) <= set(port_pkg.__all__), set(jax_pkg.__all__) - set(port_pkg.__all__)
    assert all(getattr(port_pkg, n) is not None for n in port_pkg.__all__)


def test_attention_packed_is_the_kernel_wrapper():
    assert t_ops.attention_packed is t_ops.fused_attention_packed
    assert importlib.import_module("roma_tpu_torch.ops.attention").attention_packed is t_ops.fused_attention_packed


def _coords(seed, *shape):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, shape).astype(np.float32)


@pytest.mark.parametrize("h,w", [(70, 90), (864, 1728), (13, 7)])
def test_coordinate_maps_equal_jax(h, w):
    c = _coords(0, 3, 50, 2)
    warp = _coords(1, 40, 30, 4)
    pix = (c + 1.2) * np.float32(w / 2.4)
    pairs = [
        (t_ops.to_pixel_coords(torch.from_numpy(c), h, w), j_ops.to_pixel_coords(jnp.asarray(c), h, w)),
        (t_ops.to_normalized_coords(torch.from_numpy(pix), h, w), j_ops.to_normalized_coords(jnp.asarray(pix), h, w)),
        (t_ops.warp_to_pixel_coords(torch.from_numpy(warp), h, w, w, h),
         j_ops.warp_to_pixel_coords(jnp.asarray(warp), h, w, w, h)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_matchers_coordinate_methods_are_the_ops():
    m = RegressionMatcher.__new__(RegressionMatcher)
    k = torch.from_numpy(_coords(2, 30, 4))
    a, b = m.to_pixel_coordinates(k, 70, 90, 120, 80)
    assert torch.equal(a, t_ops.to_pixel_coords(k[:, :2], 70, 90))
    assert torch.equal(b, t_ops.to_pixel_coords(k[:, 2:], 120, 80))
    assert torch.equal(m.to_pixel_coordinates(k[:, :2], 70, 90), a)
    na, nb = m.to_normalized_coordinates((a, b), 70, 90, 120, 80)
    assert torch.equal(na, t_ops.to_normalized_coords(a, 70, 90))
    assert torch.equal(nb, t_ops.to_normalized_coords(b, 120, 80))
    torch.testing.assert_close(torch.cat((na, nb), -1), k, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shapes", [((2, 5, 7, 16), (2, 6, 4, 16)), ((1, 8, 8, 64), (1, 8, 8, 64))],
                         ids=["ragged", "square"])
def test_corr_volume_equals_jax(shapes):
    rs = np.random.RandomState(3)
    f0, f1 = (rs.randn(*s).astype(np.float32) for s in shapes)
    got = t_ops.corr_volume(torch.from_numpy(f0), torch.from_numpy(f1))
    want = np.asarray(j_ops.corr_volume(jnp.asarray(f0), jnp.asarray(f1)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # Tiny RoMa's query-major volume is the same product, transposed
    from roma_tpu_torch.models.tiny import corr_volume_qmajor

    b, h1, w1, h0, w0 = got.shape
    q = corr_volume_qmajor(torch.from_numpy(f0), torch.from_numpy(f1))
    assert torch.equal(q, got.reshape(b, h1 * w1, h0 * w0).transpose(1, 2))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(4)
    files = {}
    rgb = (rs.rand(37, 53, 3) * 255).astype(np.uint8)
    files["rgb"] = d / "rgb.png"
    Image.fromarray(rgb).save(files["rgb"])
    files["gray"] = d / "gray.png"
    Image.fromarray(rgb[..., 0]).save(files["gray"])
    files["i16"] = d / "i16.png"
    Image.fromarray((rs.rand(21, 30) * 60000).astype(np.uint16)).save(files["i16"])
    files["rgba"] = d / "rgba.png"
    Image.fromarray((rs.rand(20, 24, 4) * 255).astype(np.uint8)).save(files["rgba"])
    return {k: str(v) for k, v in files.items()}


def _outcome(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kind", ["rgb", "gray", "i16", "rgba"])
def test_image_checks_equal_jax(image_files, kind):
    im = Image.open(image_files[kind])
    for name in ("check_not_i16", "check_rgb"):
        got, want = _outcome(getattr(t_utils, name), im), _outcome(getattr(j_utils, name), im)
        assert got == want, (name, got, want)
    assert (_outcome(t_utils.check_not_i16, im) is not None) == (im.mode == "I;16")
    assert (_outcome(t_utils.check_rgb, im) is None) == (kind == "rgb")


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("size_hw,normalize", [(None, True), ((28, 42), True), ((30, 20), False)])
def test_prepare_equals_jax(image_files, kind, size_hw, normalize):
    (got, hw), (want, want_hw) = (m.prepare(image_files[kind], size_hw, normalize) for m in (t_utils, j_utils))
    assert hw == want_hw and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_vit_large_layout_equals_jax():
    """Every JAX leaf of vit_large maps onto one port tensor of the same
    shape and every port tensor is covered (check_jax_shapes), and the
    parameter counts agree: 304,367,616, the frozen DINOv2 of train_net()."""
    port = torch.nn.Module()
    port.dinov2 = vit_large(device="meta")
    shapes = jax.eval_shape(jax_vit_large().init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3), jnp.float32))
    tree = {"params": {"dinov2": shapes["params"]}}
    n = check_jax_shapes(tree, port)
    assert n == len(port.state_dict())
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == jax_count == 304_367_616
    assert all(p.is_meta for p in port.parameters())
