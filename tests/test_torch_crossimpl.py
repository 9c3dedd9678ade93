"""The capstone's machinery in the port (roma_tpu_torch/tools/crossimpl.py)
and, under --runslow, the full-dims comparison with the JAX package
(tests/torch_crossimpl.py).

Tier 1 (cheap): the port's copy of the synthetic geometry and bias against
tools/crossimpl_auc.py's, exact on a small grid; capstone_net's seeded
weights (drawn on the CPU, reproducible, BN stats perturbed, flow rows
scaled, the amp path's dtypes) at RoMaConfig.tiny(); the logits capture and
the bias it solves; PrecomputedMatcher's sampling equal to the matcher's.

Slow (the runner's own functions: the port's passes computed anew, JAX's
cached in build/ under a digest of its sources, weights and inputs): at
560 -> 864 the port's float32 per-scale flow and certainty within 2e-3 of
JAX float32, and the capstone's AUC@5/10/20 within 0.5 pp of JAX's at
refiner_flow_gain 0.02 and 1.0 through the same downstream (comparison (a));
comparison (b) and the bf16 drift are recorded, not gated here.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import crossimpl_auc as ref  # noqa: E402

from roma_tpu_torch.models.config import RoMaConfig  # noqa: E402
from roma_tpu_torch.models.roma import RegressionMatcher  # noqa: E402
from roma_tpu_torch.tools import crossimpl as xi  # noqa: E402


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_geometry_equals_the_jax_tool(idx):
    hw = (48, 64) if idx == 1 else (56, 56)
    s, r = xi.make_scene(idx, hw), ref.make_scene(idx, hw)
    for k in ("K1", "K2", "R", "t"):
        assert np.array_equal(getattr(s, k), getattr(r, k))
    assert (s.hw_A, s.hw_B, s.amp, s.phase) == (r.hw_A, r.hw_B, r.amp, r.phase)
    g = np.linspace(-0.95, 0.95, 13)
    pts = np.stack(np.meshgrid(g, g[::-1], indexing="xy"), -1)
    for direction in ("AtoB", "BtoA"):
        assert np.array_equal(xi.gt_warp(s, pts, direction), ref.gt_warp(r, pts, direction))
    for a, b in zip(xi.scene_images(idx, 28, 42), ref.scene_images(idx, 28, 42)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cls_res", [16, 64])
def test_bias_equals_the_jax_tool(cls_res):
    s, r = xi.make_scene(1, (64, 64)), ref.make_scene(1, (64, 64))
    grid = (4, 5)
    assert np.array_equal(xi.render_gt_bias(s, grid, cls_res=cls_res), ref.render_gt_bias(r, grid, cls_res=cls_res))
    logits = np.random.RandomState(cls_res).randn(2, *grid, cls_res * cls_res).astype(np.float32)
    got = xi.render_gt_bias(s, grid, cls_res=cls_res, amp=60.0, model_logits=logits)
    assert np.array_equal(got, ref.render_gt_bias(r, grid, cls_res=cls_res, amp=60.0, model_logits=logits))
    assert np.array_equal(xi._decode_cls(logits + got, cls_res), ref._decode_cls(logits + got, cls_res))


@pytest.fixture(scope="module")
def tiny_nets():
    cfg = RoMaConfig.tiny()
    return {g: xi.capstone_net(0, g, "cpu", config=cfg) for g in (1.0, 0.02)}


def test_capstone_net_is_seeded_and_perturbed(tiny_nets):
    cfg = RoMaConfig.tiny()
    again = xi.capstone_net(0, 1.0, "cpu", config=cfg).state_dict()
    full, damped = tiny_nets[1.0].state_dict(), tiny_nets[0.02].state_dict()
    assert all(torch.equal(again[k], v) for k, v in full.items())
    other = xi.capstone_net(1, 1.0, "cpu", config=cfg).state_dict()
    assert any(not torch.equal(other[k], v) for k, v in full.items())
    means = [v for k, v in full.items() if k.endswith("running_mean")]
    vars_ = [v for k, v in full.items() if k.endswith("running_var")]
    assert means and all(m.abs().max() <= 0.2 and m.abs().max() > 0 for m in means)
    assert all(((v >= 0.8) & (v <= 1.2)).all() and v.std() > 0 for v in vars_)
    for k, v in full.items():
        if ".out_conv." in k:
            assert torch.equal(damped[k][:2], v[:2] * 0.02) and torch.equal(damped[k][2:], v[2:]), k
        else:
            assert torch.equal(damped[k], v), k
    amp = xi.capstone_net(0, 1.0, "cpu", amp=True, config=cfg)
    assert next(amp.encoder.cnn.parameters()).dtype == torch.bfloat16
    assert next(amp.decoder.gps.parameters()).dtype == torch.float32
    assert all(r.out_conv.weight.dtype == torch.float32 for r in amp.decoder.conv_refiner.values())
    gelus = [m for m in amp.encoder.dinov2.modules() if isinstance(m, torch.nn.GELU)]
    assert gelus and all(m.approximate == "tanh" for m in gelus)


def test_logits_capture_solves_the_bias(tiny_nets):
    """The bias solved from the captured logits makes the coarse classifier
    decode the scene's ground truth (in view)."""
    net = tiny_nets[1.0]
    coarse, up = 56, 64
    im_A, im_B, _, _ = xi.scene_images(0, coarse, up)
    logits = xi.capture_cls_logits(net, im_A, im_B)
    assert logits.shape == (2, 4, 4, 256) and logits.dtype == np.float32
    bias = xi.scene_bias(net, 0, coarse, up)
    dec = xi._decode_cls(logits.astype(np.float64) + bias, 16)
    g = np.linspace(-1 + 1 / 4, 1 - 1 / 4, 4)
    pts = np.stack(np.meshgrid(g, g, indexing="xy"), -1)
    gt = xi.gt_warp(xi.make_scene(0, (up, up)), pts, "AtoB")
    inview = (np.abs(gt) < 1 - 2 / 16).all(-1)
    assert inview.any() and np.abs(dec[0] - gt)[inview].max() < 0.3 * 2 / 16


def test_precomputed_matcher_samples_as_the_matcher(tiny_nets):
    m = RegressionMatcher(tiny_nets[1.0], h=56, w=56, upsample_res=(64, 64))
    rs = np.random.RandomState(0)
    warp = torch.from_numpy(rs.uniform(-1, 1, (64, 128, 4)).astype(np.float32))
    cert = torch.from_numpy(rs.rand(64, 128).astype(np.float32))
    pm = xi.PrecomputedMatcher({"a": (warp, cert)})
    assert pm.match("a", "a_B")[0] is warp
    for key in (0, 12345):
        got, want = pm.sample(warp, cert, 300, key=key), m.sample(warp, cert, 300, key=key)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for g, w in zip(pm.to_pixel_coordinates(got[0], 64, 64, 64, 64),
                                                      m.to_pixel_coordinates(want[0], 64, 64, 64, 64)))
    with pytest.raises(ValueError, match="keys"):
        pm.sample(warp, cert, 10)


def test_scene_pairs_carry_the_geometry():
    pairs = xi.scene_pairs(3, 864)
    for i, p in enumerate(pairs):
        s = xi.make_scene(i, (864, 864))
        assert p.im_A == xi.scene_tag(i) and np.array_equal(p.K1, s.K1) and np.array_equal(p.R, s.R)
        assert p.hw_A == p.hw_B == (864, 864)


def test_jax_cache_is_keyed_by_what_the_pass_was_computed_from(tmp_path, monkeypatch):
    """A JAX pass is reused only for the same JAX sources, weights and
    inputs; the cache lies in the checkout."""
    import torch_crossimpl as tc

    assert os.path.commonpath([tc.CACHE, tc.ROOT]) == tc.ROOT
    made = []

    def make():
        made.append(1)
        return {"x": np.full(3, len(made), np.float32)}

    class W:
        digest = "w0"

    x = np.arange(4, dtype=np.float32)
    run = lambda w=W, inputs=(x,), kind="match_jax_f32": tc.jax_cached(kind, w, inputs, make, str(tmp_path))["x"][0]
    assert run() == 1 and run() == 1
    assert run(inputs=(x + 1,)) == 2 and run(inputs=(x.astype(np.float64),)) == 3
    assert run(kind="match_jax_bf16") == 4
    W.digest = "w1"
    assert run() == 5
    monkeypatch.setattr(tc, "jax_sources", lambda: "changed")
    assert run() == 6 and run() == 6
    assert len(list(tmp_path.glob("*.npz"))) == 6


@pytest.mark.slow
def test_full_dims_parity_with_jax():
    import torch_crossimpl as tc

    rec = tc.per_scale_parity(560, 864)
    assert rec["f32_within"], rec["f32_port_vs_jax"]


@pytest.mark.slow
def test_capstone_auc_within_half_a_point_of_jax():
    import torch_crossimpl as tc

    out = tc.capstone(560, 864)
    for gain, rec in out.items():
        assert rec["a_within"], (gain, rec["a_delta_pp"])
        assert rec["auc"]["jax_f32"]["auc_20"] > 0.2, (gain, rec["auc"])
