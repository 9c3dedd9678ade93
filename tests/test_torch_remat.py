"""RoMaNet(remat=True), the port's rematerialized training path, against the
plain path at RoMaConfig.tiny() on the CPU: the same parameter names, the
same outputs, gradients within tests/test_remat.py's bars (atol 1e-5 of the
largest gradient entry, rtol 2e-3), and the BatchNorm running statistics
moved exactly once a step (equal to the plain path's, tolerance 0). A
planted double update (the recompute without ``frozen_bn_stats``) must break
that last check. Also Kernel A's forward count under remat, which chip_smoke
holds the card to: the TransformerDecoder's blocks run again in the
backward."""
import contextlib
import copy
import importlib

import numpy as np
import pytest
import torch

from roma_tpu_torch.models import blocks
from roma_tpu_torch.models.config import RoMaConfig
from roma_tpu_torch.models.zoo import train_net
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)
# the module, which the package's function of the same name hides
fa = importlib.import_module("roma_tpu_torch.ops.fused_attention")

TINY = RoMaConfig.tiny()


def _images(seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.rand(2, 56, 56, 3).astype(np.float32)) for _ in range(2)]


@pytest.fixture(scope="module")
def base_net():
    return train_net(TINY, "cpu", seed=0)


def _run(net0, remat: bool, steps: int = 2):
    """Forward + backward of the |output| sum, ``steps`` times on the same
    images (the running statistics move each time); the outputs, gradients
    and state after the last."""
    net = train_net(TINY, "cpu", seed=0, remat=remat)
    net.load_state_dict(net0.state_dict())
    for i in range(steps):
        net.zero_grad(set_to_none=True)
        corresps = net(*_images(i))
        loss = sum(v.float().abs().sum() for s in corresps.values() for v in s.values())
        loss.backward()
    outs = {f"{s}.{k}": v.detach() for s, d in corresps.items() for k, v in d.items()}
    grads = {k: p.grad for k, p in net.named_parameters() if p.grad is not None}
    return loss.item(), outs, grads, {k: v.clone() for k, v in net.state_dict().items()}


def assert_bn_stats_equal(a: dict, b: dict):
    keys = [k for k in a if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert len(keys) == 3 * (sum(len(s) for s in TINY.vgg_channels) + 5 + 5 * (1 + TINY.hidden_blocks))
    for k in keys:
        assert torch.equal(a[k], b[k]), k


def test_remat_keeps_names_outputs_grads_and_bn_stats(base_net):
    plain, remat = _run(base_net, False), _run(base_net, True)
    assert [k for k, _ in train_net(TINY, "cpu", remat=True).named_parameters()] == \
        [k for k, _ in base_net.named_parameters()]
    assert np.isclose(remat[0], plain[0], rtol=1e-6)
    for k, v in plain[1].items():
        np.testing.assert_allclose(remat[1][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    assert sorted(remat[2]) == sorted(plain[2])
    gmax = max(g.abs().max().item() for g in plain[2].values())
    for k, g in plain[2].items():
        np.testing.assert_allclose(remat[2][k].numpy(), g.numpy(), atol=1e-5 * gmax, rtol=2e-3, err_msg=k)
    assert_bn_stats_equal(remat[3], plain[3])


def test_a_planted_double_bn_update_fails(base_net, monkeypatch):
    plain = _run(base_net, False, steps=1)
    monkeypatch.setattr(blocks, "frozen_bn_stats", lambda module: contextlib.nullcontext())
    doubled = _run(base_net, True, steps=1)
    with pytest.raises(AssertionError):
        assert_bn_stats_equal(doubled[3], plain[3])


def test_remat_recomputes_the_decoder_attention(base_net, monkeypatch):
    """Kernel A's forward (its plain version on the CPU) runs for DINOv2 and
    the decoder, then again for the decoder's blocks under remat; E once a
    decoder block either way."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.attention_packed_reference, fa.attention_backward_reference

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "attention_packed_reference", count("fwd", fwd))
    monkeypatch.setattr(fa, "attention_backward_reference", count("bwd", bwd))
    for remat, want in ((False, TINY.dino_depth + TINY.decoder_depth),
                        (True, TINY.dino_depth + 2 * TINY.decoder_depth)):
        calls.update(fwd=0, bwd=0)
        net = copy.deepcopy(base_net).set_remat(remat)
        corresps = net(*_images(0))
        sum(v.float().abs().sum() for s in corresps.values() for v in s.values()).backward()
        assert calls == {"fwd": want, "bwd": TINY.decoder_depth}, (remat, calls)


def test_remat_checkpoints_only_in_training(base_net, monkeypatch):
    """Only a training forward is checkpointed: eval mode (the matcher) runs as without remat."""
    seen = []
    monkeypatch.setattr(blocks, "checkpoint", lambda *a, **k: seen.append(1) or a[0](*a[1:]))
    net = train_net(TINY, "cpu", seed=0, remat=True)
    with torch.no_grad():
        net.eval()(*_images(0))
    assert not seen
    net.train()(*_images(0))
    assert len(seen) == 1 + 2 + 5 * (1 + (1 + TINY.hidden_blocks))  # VGG, GP + decoder, refiners and blocks
