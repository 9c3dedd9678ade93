"""The port's big-RoMa slice against the JAX package at RoMaConfig.tiny(),
float32 on the CPU, with the same weights on both sides: the coarse pass,
the upsample pass, the coarse pass under a peaked logit bias, the full
two-pass match, and KDE / balanced sampling."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu.models.roma import RegressionMatcher as JaxMatcher
from roma_tpu.ops.kde import kde as jax_kde
from roma_tpu_torch.models.roma import RegressionMatcher
from roma_tpu_torch.ops import kde
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

ATOL = 2e-3  # the bar of tests/test_roma_parity.py:427-437


@pytest.fixture(scope="module")
def nets():
    variables = seeded_tiny_variables(0)
    return variables, port_net(variables)


def _imgs(seed, hw=56):
    return np.random.RandomState(seed).randn(1, hw, hw, 3).astype(np.float32) * 0.5


def _compare(jc, tc, scales):
    for s in scales:
        for k in ("flow", "certainty"):
            np.testing.assert_allclose(
                tc[s][k].numpy(), np.asarray(jc[s][k]), atol=ATOL, err_msg=f"{k} scale {s}"
            )


def _coarse(nets, gm_logit_bias=None, seeds=(1, 2)):
    variables, net = nets
    a, b = _imgs(seeds[0]), _imgs(seeds[1])
    jc = JaxNet(config=TINY).apply(
        variables, jnp.asarray(a), jnp.asarray(b), symmetric=True, scale_factor=0.1,
        gm_logit_bias=None if gm_logit_bias is None else jnp.asarray(gm_logit_bias),
    )
    with torch.no_grad():
        tc = net(torch.from_numpy(a), torch.from_numpy(b), symmetric=True, scale_factor=0.1,
                 gm_logit_bias=None if gm_logit_bias is None else torch.from_numpy(gm_logit_bias))
    _compare(jc, tc, (16, 8, 4, 2, 1))


def test_coarse_pass_matches_jax(nets):
    _coarse(nets)


def test_coarse_pass_peaked_logits_matches_jax(nets):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from fullres_parity import render_peaked_bias

    _coarse(nets, render_peaked_bias(4, 4, cls_res=TINY.cls_res), seeds=(5, 6))


def _upsample(nets, coarse, up):
    """The upsample pass on ``up``-sized images from a flow on the ``coarse``
    grid, its refiners at scale_factor up / 560."""
    variables, net = nets
    a, b = _imgs(3, up), _imgs(4, up)
    rs = np.random.RandomState(7)
    gy, gx = np.meshgrid(np.linspace(-1, 1, coarse), np.linspace(-1, 1, coarse), indexing="ij")
    flow = (np.stack([gx, gy], -1)[None].repeat(2, 0) * 0.9 + 0.03 * rs.randn(2, coarse, coarse, 2))
    flow = flow.astype(np.float32)
    cert = rs.randn(2, coarse, coarse, 1).astype(np.float32)
    sf = up / 560
    jc = JaxNet(config=TINY).apply(
        variables, jnp.asarray(a), jnp.asarray(b), symmetric=True, upsample=True,
        flow=jnp.asarray(flow), certainty=jnp.asarray(cert), scale_factor=sf,
    )
    with torch.no_grad():
        tc = net(torch.from_numpy(a), torch.from_numpy(b), symmetric=True, upsample=True,
                 flow=torch.from_numpy(flow), certainty=torch.from_numpy(cert), scale_factor=sf)
    assert 16 not in tc
    _compare(jc, tc, (8, 4, 2, 1))


def test_upsample_pass_matches_jax(nets):
    _upsample(nets, 56, 64)


# Mega-1500's 672 -> 1344: the refinement canvas twice the coarse one
TWICE = pytest.mark.parametrize("coarse, up", [(56, 112), (84, 168)], ids=["56to112", "84to168"])


@TWICE
def test_upsample_pass_at_twice_the_canvas_matches_jax(nets, coarse, up):
    _upsample(nets, coarse, up)


def _match(nets, coarse, up):
    """The two-pass match of one pair at ``coarse`` -> ``up``, JAX's and the
    port's; returns the port's matcher and warp and certainty."""
    variables, net = nets
    a, b = _imgs(8, coarse)[0], _imgs(9, coarse)[0]
    jw, jcert = JaxMatcher(variables, h=coarse, w=coarse, upsample_res=(up, up), config=TINY).match(a, b)
    tm = RegressionMatcher(net, h=coarse, w=coarse, upsample_res=(up, up))
    tw, tcert = tm.match(a, b)
    assert tw.shape == (up, 2 * up, 4) and tcert.shape == (up, 2 * up)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(tcert.numpy(), np.asarray(jcert), atol=ATOL)
    return tm, tw, tcert


@TWICE
def test_match_end_to_end_at_twice_the_canvas_matches_jax(nets, coarse, up):
    _match(nets, coarse, up)


def test_match_end_to_end_matches_jax(nets):
    tm, tw, tcert = _match(nets, 56, 64)

    # balanced sampling, by its properties: rows of the warp, reproducible
    # for one generator, certainty thresholded as in the JAX package
    g = lambda: torch.Generator().manual_seed(3)
    m1, c1 = tm.sample(tw, tcert, num=200, generator=g())
    m2, _ = tm.sample(tw, tcert, num=200, generator=g())
    assert m1.shape == (200, 4) and c1.shape == (200,)
    assert torch.equal(m1, m2)
    rows = tw.reshape(-1, 4)
    assert all(((rows == m).all(-1)).any() for m in m1[:20])
    assert (m1.abs() <= 1).all() and (c1 > 0).all() and (c1 <= 1).all()
    ka, kb = tm.to_pixel_coordinates(m1, 64, 64, 64, 64)
    assert ka.shape == (200, 2) and (ka >= 0).all() and (kb <= 64).all()


def test_match_from_pil_matches_jax(nets):
    """The host path: PIL decode, bicubic resize to both resolutions,
    ImageNet normalization."""
    from PIL import Image

    variables, net = nets
    rs = np.random.RandomState(11)
    pils = [Image.fromarray((rs.rand(90, 120, 3) * 255).astype(np.uint8)) for _ in range(2)]
    jw, jcert = JaxMatcher(variables, h=56, w=56, upsample_res=(64, 64), config=TINY).match(*pils)
    tw, tcert = RegressionMatcher(net, h=56, w=56, upsample_res=(64, 64)).match(*pils)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(tcert.numpy(), np.asarray(jcert), atol=ATOL)


def test_kde_matches_jax():
    x = np.random.RandomState(0).uniform(-1, 1, (5000, 4)).astype(np.float32)
    ref = np.asarray(jax_kde(jnp.asarray(x), std=0.1))
    got = kde(torch.from_numpy(x), std=0.1).numpy()
    # same formula; ||a||^2 + ||b||^2 - 2ab cancels, so the float32 dot
    # products' summation order shows at ~2e-5 relative
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


def test_multinomial_never_draws_zero_weight():
    from roma_tpu_torch.ops import multinomial_no_replacement

    w = torch.zeros(1000)
    w[::10] = torch.rand(100, generator=torch.Generator().manual_seed(0)) + 0.1
    idx = multinomial_no_replacement(w, 100, generator=torch.Generator().manual_seed(1))
    assert len(set(idx.tolist())) == 100 and (idx % 10 == 0).all()
