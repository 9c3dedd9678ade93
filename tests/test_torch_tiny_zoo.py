"""The port's ``tiny_roma_v1_outdoor`` (roma_tpu_torch.models.zoo) and its
loader of reference-format weights, on the CPU.

The reference-format files come from the executable spec of
tests/test_tiny.py (``TinyTorch``: XFeat and the two matchers, written apart
from the port): the tiny ``.pth`` holds the matchers, as the released file
does (the reference hides XFeat from its state dict), and the XFeat file is
the hub model's state dict with its keypoint, heatmap and fine-matcher heads.
The loader must fill every port tensor with the file's value, drop the heads,
refuse a key it has no place for, agree with the JAX converter, and give the
spec's forward (the JAX package's bar against the spec, atol 5e-4). Also:
both files or neither, the offline path's seeded random weights, the shared
cache, and the default ``device="cuda"`` raising without a card."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from roma_tpu.models.tiny import TinyRoMaNet as JaxTinyRoMaNet
from roma_tpu.models.zoo import convert as jconvert
from roma_tpu_torch import tiny_roma_v1_outdoor
from roma_tpu_torch.models import zoo
from roma_tpu_torch.models.convert import to_port_layout
from roma_tpu_torch.models.zoo import download
from roma_tpu_torch.models.zoo.convert import XFEAT_PREFIX, to_reference
from test_tiny import TinyTorch

HEADS = {"keypoint_head.0.layer.0.weight": (64, 64, 1, 1), "heatmap_head.2.weight": (1, 64, 1, 1),
         "fine_matcher.0.weight": (512, 128), "fine_matcher.0.bias": (512,)}


@pytest.fixture(scope="module")
def reference():
    """(spec module, tiny state dict, XFeat hub state dict with its heads)."""
    torch.manual_seed(0)
    spec = TinyTorch(exact_softmax=True).eval()
    for m in spec.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.8, 1.2)
    sd = spec.state_dict()
    tiny_sd = {k: v for k, v in sd.items() if not k.startswith(XFEAT_PREFIX)}
    xfeat_sd = {k[len(XFEAT_PREFIX):]: v for k, v in sd.items() if k.startswith(XFEAT_PREFIX)}
    xfeat_sd.update({k: torch.randn(s) for k, s in HEADS.items()})
    return spec, tiny_sd, xfeat_sd


def _files(tmp_path, tiny_sd, xfeat_sd):
    paths = tmp_path / "tiny_roma_v1_outdoor.pth", tmp_path / "xfeat.pt"
    torch.save(tiny_sd, paths[0])
    torch.save(xfeat_sd, paths[1])
    return paths


@pytest.mark.parametrize("source", ["files", "dicts"])
def test_loads_the_reference_files_tensor_for_tensor(reference, tmp_path, source):
    spec, tiny_sd, xfeat_sd = reference
    args = _files(tmp_path, tiny_sd, xfeat_sd) if source == "files" else (tiny_sd, xfeat_sd)
    m = tiny_roma_v1_outdoor(*args, exact_softmax=True, device="cpu")
    got = {k: v for k, v in m.net.state_dict().items() if not k.endswith("num_batches_tracked")}
    want = {k: v for k, v in spec.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not m.net.training and m.net.exact_softmax


def test_loader_agrees_with_the_jax_converter(reference):
    _, tiny_sd, xfeat_sd = reference
    m = tiny_roma_v1_outdoor(tiny_sd, xfeat_sd, device="cpu")
    variables = jconvert.convert_tiny_roma(jconvert.state_dict_to_numpy(tiny_sd), jconvert.state_dict_to_numpy(xfeat_sd))
    want = to_port_layout(variables)
    got = m.net.state_dict()
    assert len(want) == len([k for k in got if not k.endswith("num_batches_tracked")])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("shapes", [((64, 96), (64, 96)), ((64, 96), (96, 64))], ids=["equal", "unequal"])
def test_loaded_net_gives_the_spec_forward(reference, shapes):
    spec, tiny_sd, xfeat_sd = reference
    net = tiny_roma_v1_outdoor(tiny_sd, xfeat_sd, exact_softmax=True, device="cpu").net
    rs = np.random.RandomState(3)
    im_a, im_b = (rs.rand(1, *hw, 3).astype(np.float32) for hw in shapes)
    with torch.no_grad():
        coarse, fine = spec(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (im_a, im_b)))
        got = net(torch.from_numpy(im_a), torch.from_numpy(im_b))
    for s, ref in ((8, coarse), (4, fine)):
        both = torch.cat((got[s]["flow"], got[s]["certainty"]), dim=-1)
        np.testing.assert_allclose(both.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=5e-4, rtol=1e-3)
    corr = JaxTinyRoMaNet(exact_softmax=True).apply(
        jconvert.convert_tiny_roma(jconvert.state_dict_to_numpy(tiny_sd), jconvert.state_dict_to_numpy(xfeat_sd)),
        jnp.asarray(im_a), jnp.asarray(im_b))
    np.testing.assert_allclose(got[4]["flow"].numpy(), np.asarray(corr[4]["flow"]), atol=5e-4, rtol=1e-3)


def test_round_trip_through_the_reference_layout(reference, tmp_path):
    _, tiny_sd, xfeat_sd = reference
    m = tiny_roma_v1_outdoor(tiny_sd, xfeat_sd, device="cpu")
    t2, x2 = to_reference(m.net, XFEAT_PREFIX)
    again = tiny_roma_v1_outdoor(*_files(tmp_path, t2, x2), device="cpu")
    for (k, a), b in zip(m.net.state_dict().items(), again.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert sorted(x2) == sorted(k for k in xfeat_sd if k not in HEADS and not k.endswith("num_batches_tracked"))


def test_heads_are_dropped_and_other_keys_refused(reference):
    _, tiny_sd, xfeat_sd = reference
    with pytest.raises(KeyError, match="no place"):
        tiny_roma_v1_outdoor(tiny_sd, {**xfeat_sd, "block9.0.layer.0.weight": torch.zeros(1)}, device="cpu")
    with pytest.raises(KeyError, match="no place"):
        tiny_roma_v1_outdoor({**tiny_sd, "extra_head.weight": torch.zeros(1)}, xfeat_sd, device="cpu")
    with pytest.raises(KeyError, match="no reference tensor"):
        tiny_roma_v1_outdoor({k: v for k, v in tiny_sd.items() if k != "fine_matcher.4.bias"}, xfeat_sd,
                             device="cpu")
    bad = dict(tiny_sd, **{"coarse_matcher.4.weight": torch.zeros(3, 255, 1, 1)})
    with pytest.raises(ValueError):
        tiny_roma_v1_outdoor(bad, xfeat_sd, device="cpu")


def test_a_half_pair_raises(reference, monkeypatch):
    _, tiny_sd, xfeat_sd = reference
    monkeypatch.setattr(download, "fetch", lambda url: None)
    for args in ((tiny_sd, None), (None, xfeat_sd)):
        with pytest.raises(RuntimeError, match="both"):
            tiny_roma_v1_outdoor(*args, device="cpu")


def test_offline_gives_seeded_random_weights(monkeypatch):
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    monkeypatch.setattr(download.urllib.request, "urlopen", lambda *a, **k: pytest.fail("network reached"))
    a, b = (tiny_roma_v1_outdoor(device="cpu", seed=s).net.state_dict() for s in (0, 0))
    c = tiny_roma_v1_outdoor(device="cpu", seed=1).net.state_dict()
    key = "coarse_matcher.0.layer.0.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert a[key].std().item() == pytest.approx(zoo.INIT_STD, rel=0.05)
    assert torch.equal(a["xfeat.block1.0.layer.1.running_var"], torch.ones(4))
    # N(0, 0.02^2) convs shrink every layer's output: the coarse map is all but flat
    with torch.no_grad():
        coarse = tiny_roma_v1_outdoor(device="cpu", seed=0).net.xfeat(torch.rand(1, 64, 96, 3))[1]
    assert coarse.abs().mean() < 1e-6


def test_cached_files_are_used(reference, monkeypatch, tmp_path):
    """Both packages' cache: files named as the release URLs' basenames."""
    _, tiny_sd, xfeat_sd = reference
    monkeypatch.setenv("ROMA_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    _files(tmp_path, tiny_sd, xfeat_sd)
    assert [u.rsplit("/", 1)[-1] for u in (zoo.WEIGHT_URLS["tiny_roma_v1"]["outdoor"], zoo.WEIGHT_URLS["xfeat"])] \
        == ["tiny_roma_v1_outdoor.pth", "xfeat.pt"]
    m = tiny_roma_v1_outdoor(device="cpu")
    assert torch.equal(m.net.state_dict()["fine_matcher.4.weight"], tiny_sd["fine_matcher.4.weight"])


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    if torch.cuda.is_available():
        assert tiny_roma_v1_outdoor().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tiny_roma_v1_outdoor()
