"""The port's MatchEngine (roma_tpu_torch/serving.py) on the CPU, at
RoMaConfig.tiny() with the weights of tests/torch_port_fixtures.py and
images written under tmp_path.

Each result must equal ``model.match`` of its pair within 1e-5 (the same
decode, resize and normalization; a batch of 2 against a batch of 1), in
input order, with the short last batch padded and dropped; an empty stream
yields nothing; corrupt inputs raise naming the pair, or are skipped without
losing their batch; arrays are taken as images; ``on_host`` gives NumPy; the
model receives match()'s preprocessing at both of its resolutions; no more
than ``INFLIGHT`` matched batches wait unread. Against the JAX package's
MatchEngine on the same weights and files: atol 2e-3 (the bar of
tests/test_roma_parity.py:427-437). Tiny RoMa (no canvas) through
``resize_hw`` and ``normalize=False``: each result equal to ``match`` of its
resized [0, 1] images, and to the JAX engine's at tests/test_tiny.py's bar;
a ``normalize`` that disagrees with the model is refused."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from roma_tpu_torch.models.roma import RegressionMatcher
from roma_tpu_torch import serving
from roma_tpu_torch.serving import MatchEngine, MatchEngineError, MatchResult
from roma_tpu_torch.utils.image import imagenet_normalize, load_image, resize
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables

TOL = 1e-5
JAX_ATOL = 2e-3
H = W = 56
UP = (64, 64)


@pytest.fixture(scope="module")
def weights():
    variables = seeded_tiny_variables(0)
    return variables, port_net(variables)


@pytest.fixture(scope="module")
def model(weights):
    return RegressionMatcher(weights[1], h=H, w=W, upsample_res=UP)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    rs = np.random.RandomState(0)
    out = []
    for i, (w, h) in enumerate([(100, 80), (90, 70), (64, 96), (120, 60), (80, 80)]):
        p = d / f"im{i}.png"
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        out.append(str(p))
    corrupt = d / "corrupt.jpg"
    corrupt.write_bytes(b"\xff\xd8\xff not a jpeg")
    return out, str(corrupt)


def _pairs(paths, n):
    return [(paths[i % len(paths)], paths[(i + 2) % len(paths)]) for i in range(n)]


_MATCHED: dict = {}


def _same_as_match(model, r: MatchResult, tol=TOL):
    key = (id(model), r.im_A, r.im_B)  # the files of a pair are written once, so match them once
    if key not in _MATCHED:
        _MATCHED[key] = model.match(r.im_A, r.im_B)
    warp, cert = _MATCHED[key]
    got_w, got_c = (torch.as_tensor(x) for x in (r.warp, r.certainty))
    assert got_w.shape == warp.shape and got_c.shape == cert.shape
    assert (got_w - warp).abs().max().item() <= tol
    assert (got_c - cert).abs().max().item() <= tol


@pytest.mark.parametrize("n,batch_size", [(5, 2), (3, 4), (4, 1)], ids=["5 pairs x2", "3 pairs x4", "4 pairs x1"])
def test_results_in_order_equal_to_match(model, paths, n, batch_size):
    pairs = _pairs(paths[0], n)
    results = list(MatchEngine(model, batch_size=batch_size).match_paths(pairs))
    assert [r.index for r in results] == list(range(n))
    assert [(r.im_A, r.im_B) for r in results] == pairs
    for r in results:
        assert r.error is None and tuple(r.warp.shape) == (64, 128, 4) and tuple(r.certainty.shape) == (64, 128)
        _same_as_match(model, r)


def test_short_batch_is_padded_and_dropped(model, paths):
    """3 pairs at batch 2: the second match runs 2 rows (the last pair
    twice) and only one result comes back from it."""
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(model, name)

        def match(self, *a, **kw):
            seen.append(tuple(a[0].shape))
            return model.match(*a, **kw)

    results = list(MatchEngine(Spy(), batch_size=2).match_paths(_pairs(paths[0], 3)))
    assert seen == [(2, H, W, 3), (2, H, W, 3)]
    assert len(results) == 3
    _same_as_match(model, results[2])


def test_empty_stream(model):
    assert list(MatchEngine(model, batch_size=2).match_paths([])) == []


def test_validation_errors(model, paths):
    with pytest.raises(ValueError, match="batch_size"):
        MatchEngine(model, batch_size=0)
    with pytest.raises(ValueError, match="canvas"):
        MatchEngine(object(), batch_size=2)
    with pytest.raises(ValueError, match="on_error"):
        list(MatchEngine(model, batch_size=2).match_paths(_pairs(paths[0], 1), on_error="ignore"))


def test_on_error_raise_names_the_pair(model, paths):
    (p, corrupt) = paths
    with pytest.raises(MatchEngineError, match="pair 1 .*corrupt") as info:
        list(MatchEngine(model, batch_size=2).match_paths([(p[0], p[1]), (corrupt, p[1])]))
    assert info.value.index == 1


def test_on_error_skip_keeps_the_batch(model, paths):
    (p, corrupt) = paths
    pairs = [(p[0], p[1]), (corrupt, p[1]), (p[2], p[3]), (p[0], "/nonexistent/im.jpg")]
    results = list(MatchEngine(model, batch_size=2).match_paths(pairs, on_error="skip"))
    assert [r.index for r in results] == [0, 1, 2, 3]
    for i in (0, 2):
        assert results[i].error is None
        _same_as_match(model, results[i])
    assert results[1].warp is None and results[1].certainty is None and results[1].error is not None
    assert isinstance(results[3].error, FileNotFoundError)


def test_array_inputs(model):
    """HWC arrays (float RGB, grayscale, RGBA, uint8) are images, as
    ``load_image`` takes them; a malformed one fails its pair."""
    rs = np.random.RandomState(1)
    rgb = rs.rand(64, 80, 3).astype(np.float32)
    gray, rgba = rgb.mean(-1), np.concatenate([rgb, np.ones((64, 80, 1), np.float32)], -1)
    u8 = (rs.rand(50, 70, 3) * 255).astype(np.uint8)
    pairs = [(rgb, gray), (rgba, u8)]
    results = list(MatchEngine(model, batch_size=2).match_paths(pairs))
    assert [r.index for r in results] == [0, 1] and all(r.error is None for r in results)
    for r, (a, b) in zip(results, pairs):
        warp, cert = model.match(load_image(a), load_image(b))
        assert (r.warp - warp).abs().max().item() <= TOL and (r.certainty - cert).abs().max().item() <= TOL
    with pytest.raises(MatchEngineError, match="pair 0"):
        list(MatchEngine(model, batch_size=2).match_paths([(np.zeros((2, 3, 4, 5)), rgb)]))


def test_on_host_gives_numpy(model, paths):
    pairs = _pairs(paths[0], 3)
    engine = MatchEngine(model, batch_size=2)
    host = list(engine.match_paths(pairs, on_host=True))
    dev = list(engine.match_paths(pairs))
    for h, d in zip(host, dev):
        assert isinstance(h.warp, np.ndarray) and isinstance(h.certainty, np.ndarray)
        assert np.array_equal(h.warp, d.warp.numpy()) and np.array_equal(h.certainty, d.certainty.numpy())


class Echo:
    """A matcher with a canvas that returns the images it is given (the A
    and B images side by side, at its upsample resolution when it has one),
    so the engine's inputs can be read back."""

    device, dtype = torch.device("cpu"), torch.float32

    def __init__(self, hw, up=None):
        self.h_resized, self.w_resized = hw
        self.upsample_preds, self.upsample_res = up is not None, up
        self.calls, self.coarse = 0, []

    def match(self, im_A, im_B, im_A_high_res=None, im_B_high_res=None):
        self.calls += 1
        self.coarse.append(torch.cat((im_A, im_B), dim=2))
        a, b = (im_A, im_B) if im_A_high_res is None else (im_A_high_res, im_B_high_res)
        return torch.cat((a, b), dim=2), a.mean(-1)


def _preprocessed(paths, hw):
    """match()'s preprocessing of each image, side by side: (h, 2w, 3)."""
    ims = [imagenet_normalize(torch.from_numpy(np.asarray(resize(load_image(x), hw), np.float32)) / 255.0)
           for x in paths]
    return torch.cat(ims, dim=1).numpy()


def test_inputs_are_match_preprocessing(paths):
    """Both resolutions of a canvas reach the model decoded, bicubic-resized,
    scaled to [0, 1] and ImageNet-normalized, row by row in pair order."""
    p = paths[0]
    stub = Echo((24, 32), up=(40, 48))
    pairs = [(p[0], p[1]), (p[2], p[3]), (p[4], p[0])]
    results = list(MatchEngine(stub, batch_size=2).match_paths(pairs, on_host=True))
    assert stub.calls == 2 and [r.index for r in results] == [0, 1, 2]
    for r, pair in zip(results, pairs):
        assert r.warp.shape == (40, 96, 3)
        np.testing.assert_allclose(r.warp, _preprocessed(pair, (40, 48)), rtol=0, atol=1e-6)
    for k, pair in enumerate(pairs):
        got = stub.coarse[k // 2][k % 2].numpy()
        np.testing.assert_allclose(got, _preprocessed(pair, (24, 32)), rtol=0, atol=1e-6)


def test_inflight_bounds_unread_batches(paths, monkeypatch):
    """With INFLIGHT 1, at most one matched batch beyond the one being read
    has been dispatched when a result is yielded."""
    monkeypatch.setattr(serving, "INFLIGHT", 1)
    monkeypatch.setattr(serving, "PREFETCH", 3)
    stub = Echo((16, 16))
    engine = MatchEngine(stub, batch_size=1)
    for k, r in enumerate(engine.match_paths(_pairs(paths[0], 6))):
        assert stub.calls <= k + 2, (k, stub.calls)
    assert stub.calls == 6


def test_order_holds_under_thread_churn(paths, monkeypatch):
    """More decode threads than cores, a tiny switch interval and batches of
    3 over 40 pairs: every result in order, each the resize of its own files."""
    import sys

    monkeypatch.setattr(serving, "WORKERS", 32)
    monkeypatch.setattr(serving, "PREFETCH", 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = paths[0]
        pairs = [(p[i % 5], p[(3 * i + 1) % 5]) for i in range(40)]
        results = list(MatchEngine(Echo((8, 12)), batch_size=3).match_paths(pairs, on_host=True))
    finally:
        sys.setswitchinterval(old)
    assert [r.index for r in results] == list(range(40))
    for r, pair in zip(results, pairs):
        np.testing.assert_allclose(r.warp, _preprocessed(pair, (8, 12)), rtol=0, atol=1e-6)


def test_stops_cleanly_when_the_reader_stops(model, paths, monkeypatch):
    monkeypatch.setattr(serving, "PREFETCH", 1)
    engine = MatchEngine(model, batch_size=1)
    stream = engine.match_paths(_pairs(paths[0], 6))
    first = next(stream)
    stream.close()
    _same_as_match(model, first)


def test_against_the_jax_engine(weights, model, paths):
    """The JAX package's MatchEngine on the same weights and files."""
    from roma_tpu.models.roma import RegressionMatcher as JaxMatcher
    from roma_tpu.serving import MatchEngine as JaxEngine

    jax_model = JaxMatcher(weights[0], h=H, w=W, upsample_res=UP, config=TINY)
    pairs = _pairs(paths[0], 3)
    got = list(MatchEngine(model, batch_size=2).match_paths(pairs, on_host=True))
    ref = list(JaxEngine(jax_model, batch_size=2).match_paths(pairs, on_host=True))
    assert [r.index for r in got] == [r.index for r in ref] == [0, 1, 2]
    for g, r in zip(got, ref):
        assert g.warp.shape == r.warp.shape and g.certainty.shape == r.certainty.shape
        np.testing.assert_allclose(g.warp, r.warp, rtol=0, atol=JAX_ATOL)
        np.testing.assert_allclose(g.certainty, r.certainty, rtol=0, atol=JAX_ATOL)


# --- a matcher without a canvas: Tiny RoMa, resize_hw and normalize=False ----

TINY_HW = (64, 96)


@pytest.fixture(scope="module")
def tiny():
    from roma_tpu_torch.models.tiny import TinyRoMa
    from torch_port_fixtures import port_tiny_net, seeded_tiny_roma_variables

    variables = seeded_tiny_roma_variables(0)
    return variables, TinyRoMa(port_tiny_net(variables))


def test_tiny_needs_resize_hw(tiny):
    with pytest.raises(ValueError, match="resize_hw"):
        MatchEngine(tiny[1], batch_size=2)


def test_normalize_must_agree_with_the_model(tiny, model):
    """normalize=True hands TinyRoMa ImageNet-normalized images and
    normalize=False hands a RegressionMatcher [0, 1] images: both refused."""
    with pytest.raises(ValueError, match=r"normalize=True but TinyRoMa takes \[0, 1\] images"):
        MatchEngine(tiny[1], batch_size=2, resize_hw=TINY_HW)
    with pytest.raises(ValueError, match="normalize=False but RegressionMatcher takes ImageNet-normalized"):
        MatchEngine(model, batch_size=2, normalize=False)


def test_tiny_with_resize_hw_and_no_normalization(tiny, paths):
    """Each result equals tiny.match of its images resized to resize_hw and
    scaled to [0, 1] (no ImageNet normalization), a batch of 2 against a
    batch of 1; and the JAX engine's on the same weights and files at the
    bar of tests/test_tiny.py (atol 5e-4)."""
    from roma_tpu.models.tiny import TinyRoMa as JaxTinyRoMa
    from roma_tpu.serving import MatchEngine as JaxEngine

    variables, model = tiny
    pairs = _pairs(paths[0], 3)
    got = list(MatchEngine(model, batch_size=2, resize_hw=TINY_HW, normalize=False).match_paths(pairs))
    assert [r.index for r in got] == [0, 1, 2]
    for r in got:
        a, b = (np.asarray(resize(load_image(p), TINY_HW), np.float32) / 255.0 for p in (r.im_A, r.im_B))
        warp, cert = model.match(a, b)
        assert r.warp.shape == (*TINY_HW, 4) and r.certainty.shape == TINY_HW
        torch.testing.assert_close(r.warp, warp, rtol=0, atol=TOL)
        torch.testing.assert_close(r.certainty, cert, rtol=0, atol=TOL)
    ref = list(JaxEngine(JaxTinyRoMa(variables), batch_size=2, resize_hw=TINY_HW, normalize=False)
               .match_paths(pairs, on_host=True))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.warp.numpy(), r.warp, rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(g.certainty.numpy(), r.certainty, rtol=1e-3, atol=5e-4)
