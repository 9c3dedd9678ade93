"""The port's model zoo (roma_tpu_torch/models/zoo/) against the JAX
package's: reference-layout state dicts loaded through
roma_tpu.models.zoo.convert.convert_roma + from_jax_variables and through the
port's own loader give equal tensors, from a dict, a .pth path and a
{"model": ...} checkpoint, and from the reference modules of
test_roma_parity at the released widths; the constructors' pair, GELU, offline, cache and
download behaviour; pretrained_backbone's graft; and the port's copy of the
download module. Every network call is monkeypatched: nothing is fetched."""
from __future__ import annotations

import urllib.error

import numpy as np
import pytest
import torch
from test_zoo_download import _FakeResponse
from torch_port_fixtures import TINY as JAX_TINY
from torch_port_fixtures import port_net, seeded_tiny_variables

from roma_tpu.models.zoo import convert as jconvert
from roma_tpu_torch.models import RoMaConfig, pretrained_backbone, roma_indoor, roma_outdoor, train_net
from roma_tpu_torch.models import zoo
from roma_tpu_torch.models.convert import from_jax_variables
from roma_tpu_torch.models.zoo import convert, download

TINY = RoMaConfig.tiny()
SMALL = dict(coarse_res=56, upsample_res=64, device="cpu", config=TINY)


class _Recorder(dict):
    """A state dict that remembers which keys were read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _no_network(*a, **kw):
    pytest.fail("a test opened a network connection")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Each test: its own cache, online unless it says otherwise, the
    offline mark reset, and urlopen fails the test unless replaced."""
    monkeypatch.setattr(download, "_egress_ok", None)
    monkeypatch.setenv("ROMA_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("ROMA_TPU_OFFLINE", raising=False)
    monkeypatch.setattr(download.urllib.request, "urlopen", _no_network)


@pytest.fixture(scope="module")
def reference():
    """A reference-layout pair at the tiny config, from seeded weights,
    plus the port net holding them."""
    net = port_net(seeded_tiny_variables(3))
    roma_sd, dino_sd = convert.to_reference(net)
    return net, roma_sd, dino_sd


_orig_dinov2 = jconvert.convert_dinov2


def _jax_loaded(roma_sd, dino_sd, monkeypatch):
    """The JAX package's converter at the tiny depths (its DINOv2 depth is a
    default of convert_dinov2) and the port's from_jax_variables."""
    monkeypatch.setattr(jconvert, "convert_dinov2",
                        lambda sd, depth=JAX_TINY.dino_depth: _orig_dinov2(sd, depth))
    variables = jconvert.convert_roma(roma_sd, dino_sd, hidden_blocks=TINY.hidden_blocks,
                                      decoder_depth=TINY.decoder_depth)
    return from_jax_variables(variables, zoo.build_net(TINY, "cpu"))


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tensors(a: torch.nn.Module, b: torch.nn.Module):
    """Every parameter and running statistic equal (num_batches_tracked,
    which no checkpoint here carries, aside)."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert k.endswith("num_batches_tracked") or torch.equal(sa[k].float(), sb[k].float()), k


def test_reference_layout_is_what_the_jax_converter_reads(reference, monkeypatch):
    """to_reference writes exactly the keys convert_roma reads, and the JAX
    path gives back the net they came from."""
    net, roma_sd, dino_sd = reference
    roma_rec, dino_rec = _Recorder(_numpy(roma_sd)), _Recorder(_numpy(dino_sd))
    _assert_same_tensors(_jax_loaded(roma_rec, dino_rec, monkeypatch), net)
    assert roma_rec.read == set(roma_rec) and dino_rec.read == set(dino_rec)


@pytest.mark.parametrize("source", ["dict", "pth", "model-wrapped pth"])
def test_loader_matches_the_jax_converter(source, reference, monkeypatch, tmp_path):
    net, roma_sd, dino_sd = reference
    want = _jax_loaded(_numpy(roma_sd), _numpy(dino_sd), monkeypatch)
    if source == "dict":
        weights, dino = roma_sd, dino_sd
    else:
        weights, dino = tmp_path / "roma.pth", tmp_path / "dinov2.pth"
        torch.save({"model": roma_sd} if source.startswith("model") else roma_sd, weights)
        torch.save(dino_sd, dino)
    got = roma_outdoor(weights, dino, amp=False, **SMALL)
    _assert_same_tensors(got.net, want)
    _assert_same_tensors(got.net, net)
    assert got.net.decoder.gps.training is False and next(got.net.parameters()).dtype == torch.float32


def _spec_pair(device, monkeypatch):
    """The reference's torch modules at the released widths
    (test_roma_parity.RoMaSpec, written apart from the port) in the layout
    test_roma_parity.spec_state_dicts gives the JAX converter; on the meta
    device the tensors are kept as they are (shapes, no values)."""
    import test_roma_parity as spec_module

    torch.manual_seed(0)
    with torch.device(device):
        spec = spec_module.RoMaSpec().eval()
    if device == "meta":
        monkeypatch.setattr(jconvert, "state_dict_to_numpy",
                            lambda sd: {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")})
    else:
        for m in spec.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)
    return spec_module.spec_state_dicts(spec)


def test_the_reference_modules_layout_loads_at_full_width(monkeypatch):
    """A layout the port did not write: the reference modules' keys and
    shapes at the released widths all have their place in the port, and the
    strict loader refuses none."""
    roma_sd, dino_sd = _spec_pair("meta", monkeypatch)
    net = zoo.build_net(RoMaConfig(), "meta")
    convert.load_state(net, convert.convert_roma(roma_sd, dino_sd))
    assert len(roma_sd) + len(dino_sd) == sum(not k.endswith("num_batches_tracked") for k in net.state_dict())


@pytest.mark.slow
def test_loader_matches_the_jax_converter_on_the_reference_modules(monkeypatch):
    """The reference modules' full-width weights through roma_outdoor and
    through the JAX converter + from_jax_variables: equal tensors."""
    roma_sd, dino_sd = _spec_pair("cpu", monkeypatch)
    want = from_jax_variables(jconvert.convert_roma(roma_sd, dino_sd), zoo.build_net(RoMaConfig(), "cpu"))
    got = roma_outdoor(roma_sd, dino_sd, amp=False, device="cpu")
    _assert_same_tensors(got.net, want)


def test_to_reference_round_trips(reference):
    net, roma_sd, dino_sd = reference
    again = convert.load_state(zoo.build_net(TINY, "cpu"), convert.convert_roma(roma_sd, dino_sd))
    _assert_same_tensors(again, net)
    r2, d2 = convert.to_reference(again)
    assert all(torch.equal(r2[k], roma_sd[k]) for k in roma_sd) and r2.keys() == roma_sd.keys()
    assert all(torch.equal(d2[k], dino_sd[k]) for k in dino_sd) and d2.keys() == dino_sd.keys()
    assert not any(k.startswith("encoder.dinov2") for k in roma_sd)


def test_amp_rounds_the_loaded_weights_to_bf16(reference):
    net, roma_sd, dino_sd = reference
    m = roma_indoor(roma_sd, dino_sd, **SMALL)
    assert next(m.net.encoder.parameters()).dtype == torch.bfloat16
    assert next(m.net.decoder.gps.parameters()).dtype == torch.float32
    key = "encoder.cnn.layers.0.weight"
    assert torch.equal(m.net.state_dict()[key], roma_sd[key].bfloat16())


def test_loader_refuses_what_does_not_fit(reference):
    _, roma_sd, dino_sd = reference
    extra = {**roma_sd, "decoder.unused.weight": torch.zeros(3)}
    with pytest.raises(KeyError, match="no place in the port"):
        roma_outdoor(extra, dino_sd, amp=False, **SMALL)
    short = {k: v for k, v in roma_sd.items() if k != "decoder.gps.16.pos_conv.bias"}
    with pytest.raises(KeyError, match="no reference tensor"):
        roma_outdoor(short, dino_sd, amp=False, **SMALL)
    wrong = {**roma_sd, "decoder.gps.16.pos_conv.bias": torch.zeros(5)}
    with pytest.raises(ValueError, match="pos_conv.bias"):
        roma_outdoor(wrong, dino_sd, amp=False, **SMALL)
    with pytest.raises(KeyError, match="DINOv2 tensors too"):
        convert.convert_roma({**roma_sd, "encoder.dinov2.cls_token": dino_sd["cls_token"]}, dino_sd)


def test_dinov2_mask_token_is_not_read(reference):
    net, roma_sd, dino_sd = reference
    m = roma_outdoor(roma_sd, {**dino_sd, "mask_token": torch.zeros(1, 32)}, amp=False, **SMALL)
    _assert_same_tensors(m.net, net)


def test_a_half_pair_raises(reference):
    _, roma_sd, dino_sd = reference
    with pytest.raises(RuntimeError, match="dinov2_weights unavailable"):
        roma_outdoor(roma_sd, None, **SMALL)
    with pytest.raises(RuntimeError, match="weights unavailable"):
        roma_indoor(None, dino_sd, **SMALL)


@pytest.mark.parametrize("amp,knob,tanh", [(True, None, True), (True, False, False), (False, None, False),
                                           (False, True, True)])
def test_vit_gelu_tanh_follows_amp_unless_set(amp, knob, tanh):
    m = roma_outdoor(amp=amp, vit_gelu_tanh=knob, **SMALL)
    acts = {blk.mlp.act.approximate for blk in m.net.encoder.dinov2.blocks}
    assert acts == {"tanh" if tanh else "none"}


def _released_is_tiny(monkeypatch):
    """Treat the tiny config as the released architecture, so the fetch path
    runs at a size the CPU tier builds in a second."""
    monkeypatch.setattr(zoo, "RELEASED", TINY)


def test_offline_gives_seeded_random_weights(monkeypatch, capsys):
    _released_is_tiny(monkeypatch)
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    m = roma_outdoor(seed=4, **SMALL)
    assert capsys.readouterr().err == ""
    _assert_same_tensors(m.net, zoo.set_precision(zoo.init_random(zoo.build_net(TINY, "cpu"), 4), torch.bfloat16))


def test_no_connection_gives_random_weights_with_the_message(monkeypatch, capsys):
    _released_is_tiny(monkeypatch)

    def refused(*a, **kw):
        raise urllib.error.URLError("no route")

    monkeypatch.setattr(download.urllib.request, "urlopen", refused)
    m = roma_indoor(amp=False, seed=2, **SMALL)
    assert "weight download unavailable" in capsys.readouterr().err
    assert not download.download_available()
    _assert_same_tensors(m.net, zoo.init_random(zoo.build_net(TINY, "cpu"), 2))


def test_cached_files_are_used(reference, monkeypatch, tmp_path):
    """Each variant reads its own released file from the cache, and the
    DINOv2 file beside it; no request is made."""
    _released_is_tiny(monkeypatch)
    net, roma_sd, dino_sd = reference
    cache = tmp_path / "cache"
    cache.mkdir()
    indoor = {k: v + 1 for k, v in roma_sd.items()}
    torch.save(roma_sd, cache / "roma_outdoor.pth")
    torch.save(indoor, cache / "roma_indoor.pth")
    torch.save(dino_sd, cache / "dinov2_vitl14_pretrain.pth")
    _assert_same_tensors(roma_outdoor(amp=False, **SMALL).net, net)
    got = roma_indoor(amp=False, **SMALL).net.state_dict()
    assert all(torch.equal(got[k], indoor[k]) for k in indoor)


def test_a_mid_transfer_drop_raises(monkeypatch, tmp_path):
    _released_is_tiny(monkeypatch)
    monkeypatch.setattr(download.urllib.request, "urlopen",
                        lambda *a, **kw: _FakeResponse([b"x" * 10, b"y" * 10], fail_after=1))
    with pytest.raises(ConnectionError):
        roma_outdoor(**SMALL)
    assert not list((tmp_path / "cache").glob("*"))


def test_fetch_connection_failure_marks_the_process_offline(monkeypatch):
    def refused(*a, **kw):
        raise urllib.error.URLError("no dns")

    monkeypatch.setattr(download.urllib.request, "urlopen", refused)
    assert download.fetch("http://x/y.pth") is None
    assert not download.download_available()
    monkeypatch.setattr(download.urllib.request, "urlopen", _no_network)
    assert download.fetch("http://x/z.pth") is None


def test_fetch_writes_then_reuses_the_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(download.urllib.request, "urlopen", lambda *a, **kw: _FakeResponse([b"abc", b"def"]))
    p = download.fetch("http://x/ok.pth")
    assert p == str(tmp_path / "cache" / "ok.pth") and open(p, "rb").read() == b"abcdef"
    monkeypatch.setattr(download.urllib.request, "urlopen", _no_network)
    assert download.fetch("http://x/ok.pth") == p


def test_both_packages_share_one_cache(monkeypatch, tmp_path):
    from roma_tpu.models.zoo import download as jdownload

    assert download.cache_dir() == jdownload.cache_dir() == str(tmp_path / "cache")
    monkeypatch.delenv("ROMA_TPU_CACHE")
    assert download.cache_dir() == jdownload.cache_dir()


def _torchvision_vgg(gen):
    """A torchvision vgg19_bn state dict at the tiny widths: features.0-52
    (five stages) and a classifier the graft must not read."""
    sd, cin, i = {}, 3, 0
    for stage in (*TINY.vgg_channels, (24, 24, 24, 24)):
        for ch in stage:
            sd[f"features.{i}.weight"] = torch.randn(ch, cin, 3, 3, generator=gen)
            sd[f"features.{i}.bias"] = torch.randn(ch, generator=gen)
            for n in ("weight", "bias", "running_mean", "running_var"):
                sd[f"features.{i + 1}.{n}"] = torch.rand(ch, generator=gen) + 0.5
            sd[f"features.{i + 1}.num_batches_tracked"] = torch.tensor(7)
            cin, i = ch, i + 3
        i += 1
    sd["classifier.0.weight"] = torch.randn(8, 4, generator=gen)
    return sd


def test_pretrained_backbone_grafts_the_encoder(reference, tmp_path):
    _, _, dino_sd = reference
    gen = torch.Generator().manual_seed(8)
    vgg = _torchvision_vgg(gen)
    torch.save(vgg, tmp_path / "vgg19_bn.pth")
    net = train_net(TINY, "cpu", seed=1)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert pretrained_backbone(net, dino_sd, tmp_path / "vgg19_bn.pth") is net
    after = net.state_dict()
    for k, v in after.items():
        if k.startswith("encoder.dinov2."):
            assert torch.equal(v, dino_sd[k[len("encoder.dinov2."):]]), k
        elif k.startswith("encoder.cnn.layers.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, vgg["features." + k[len("encoder.cnn.layers."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    assert not any(p.requires_grad for p in net.encoder.dinov2.parameters())


def test_pretrained_backbone_refuses_a_wrong_shape(reference):
    _, _, dino_sd = reference
    vgg = _torchvision_vgg(torch.Generator().manual_seed(9))
    vgg["features.3.weight"] = vgg["features.3.weight"][:, :, :1]
    net = train_net(TINY, "cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(ValueError, match="features|encoder.cnn.layers.3.weight"):
        pretrained_backbone(net, dino_sd, vgg)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_pretrained_backbone_offline_warns_and_keeps_the_net(monkeypatch, capsys):
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    net = train_net(TINY, "cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert pretrained_backbone(net) is net
    assert "pretrained backbone unavailable (dinov2=missing, vgg=missing)" in capsys.readouterr().err
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_jax_zoo_reads_the_same_reference_files(reference, tmp_path):
    """The JAX package's own loader on the files the port reads (path, with
    and without the {"model": ...} wrapper) sees the same arrays."""
    from roma_tpu.models import zoo as jzoo

    _, roma_sd, _ = reference
    torch.save({"model": roma_sd}, tmp_path / "w.pth")
    theirs, ours = jzoo._load_torch_state_dict(tmp_path / "w.pth"), zoo._load_torch_state_dict(tmp_path / "w.pth")
    assert theirs.keys() == ours.keys() and all(np.array_equal(theirs[k], ours[k]) for k in ours)
