"""The plain reference agrees with the program at RoMaConfig.tiny() on the
CPU, where the program's kernels give way to their plain versions: the
two-pass match, and three training steps from the same weights."""
import numpy as np
import pytest
import torch
from PIL import Image

from perfbench.reference import roma as R
from perfbench.reference import train as RT
from perfbench.lib import traffic
from perfbench.tests.tiny import tiny_model


@pytest.fixture(scope="module")
def cfg():
    return dict(tiny_model(), vit_gelu_tanh=True)


def port_net(cfg, weights, remat=False):
    from perfbench.lib.matching import port_config
    from roma_tpu_torch.models.zoo import build_net

    net = build_net(port_config({"model": cfg}, False), "cpu", remat=remat)
    net.load_state_dict(weights)
    return net


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
def test_the_match_agrees(cfg, pinned):
    """Also with the peaked anchor-logit field that the match cells add on both sides."""
    from perfbench.lib.matching import peaked_bias
    from roma_tpu_torch.models.roma import RegressionMatcher

    bias = peaked_bias(dict(cfg, coarse_res=[56, 56]), "cpu") if pinned else None
    w = R.make_weights(cfg, 5, "cpu")
    m = RegressionMatcher(port_net(cfg, w), h=56, w=56, upsample_res=(84, 84))
    rs = np.random.RandomState(0)
    a = Image.fromarray((traffic.texture(rs, 90, 120) * 255).astype(np.uint8))
    b = a.rotate(7, resample=Image.BICUBIC)
    warp, cert = m.match(a, b, gm_logit_bias=bias)
    ins = [R.prepare(p, hw, "cpu") for hw in ((56, 56), (84, 84)) for p in (a, b)]
    rw, rc = R.match(R.RoMaReference(cfg, w), *ins, (56, 56), (84, 84), gm_logit_bias=bias)
    assert torch.allclose(warp, rw[0], atol=1e-5, rtol=0) and torch.allclose(cert, rc[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
def test_three_training_steps_agree(cfg, pinned):
    """Also with the peaked anchor-logit field that the training cell adds on both sides."""
    from perfbench.lib.matching import peaked_bias
    from roma_tpu_torch.train import RobustLosses, make_optimizer, make_train_step

    file = {"model": dict(cfg, vit_gelu_tanh=False),
            "optimizer": {"weight_decay": 0.01, "grad_clip": 0.01}}
    w = R.make_weights(file["model"], 6, "cpu")
    net = port_net(file["model"], w, remat=True).train()
    bias = peaked_bias(file["model"], "cpu", hw=(112, 112)) if pinned else None
    step = make_train_step(net, RobustLosses(), make_optimizer(net, 5e-6, 1e-4, (10 ** 6,), grad_clip=0.01),
                           forward=lambda n, b: n(b["im_A"], b["im_B"], gm_logit_bias=bias))
    rs = np.random.RandomState(1)
    batches = [{k: torch.from_numpy(v) for k, v in traffic.posed_batch(rs, 2, 112).items()} for _ in range(3)]
    got = [float(step(b)["loss"]) for b in batches]
    ref_w = R.make_weights(file["model"], 6, "cpu")
    grads = {}
    trainable = lambda k: not k.startswith("encoder.dinov2.")
    lr_of = lambda k: 5e-6 if k.startswith("encoder") else 1e-4
    want = RT.train_steps(file, ref_w, batches, trainable, lr_of, {},
                          on_step=lambda i, loss, seen: grads.update(seen) if i == 0 else None, gm_logit_bias=bias)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    w0 = R.make_weights(file["model"], 6, "cpu")
    med = float(np.median([g.norm() for g in grads.values()]))
    # each leaf's change, against the larger of its own and the median leaf's (the train cell's own measure)
    live = [k for k, p in net.named_parameters() if p.requires_grad and grads[k].norm() >= 1e-3 * med]
    got_c = {k: float((p.detach() - w0[k]).norm()) for k, p in net.named_parameters() if k in live}
    ref_c = {k: float((ref_w[k] - w0[k]).norm()) for k in live}
    med_c = float(np.median(list(ref_c.values())))
    assert len(live) > 50
    assert max(abs(got_c[k] - ref_c[k]) / max(ref_c[k], med_c) for k in live) < 1e-3
