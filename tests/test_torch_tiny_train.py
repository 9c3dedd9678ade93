"""Tiny RoMa's training slice (roma_tpu_torch.train.losses_tiny and
TinyRoMaNet in train mode) against the JAX package's, float32 on the CPU,
from numpy seeds.

The losses and their metrics within 1e-5 relative, the mutual-nearest mask
exactly; one training step through the port's ``make_train_step`` /
``make_optimizer`` (XFeat frozen, its learning rate 0, XFeat the encoder
group by its parameter names) against ``jax.value_and_grad`` of the JAX net and
losses: the loss within 1e-5 relative, each gradient within 1e-3 of its
tensor's largest entry, the matchers' BatchNorm running means equal and
their variances equal after torch's N/(N-1) correction
(tests/test_bn_semantics.py), XFeat's parameters and running statistics
unchanged and XFeat in eval mode under ``train()``. Then a few steps on
identity-pose data lower the loss (tests/test_train_convergence.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from roma_tpu.models.tiny import TinyRoMaNet as JaxTinyRoMaNet
from roma_tpu.ops import batched_grid as jax_batched_grid
from roma_tpu.train import TinyRobustLosses as JaxTinyLosses
from roma_tpu.train.gt_warp import get_gt_warp as jax_get_gt_warp
from roma_tpu.train.losses_tiny import bce_with_logits_masked as jax_bce
from roma_tpu.train.losses_tiny import mutual_nearest_mask as jax_mnn
from roma_tpu_torch.models.convert import to_port_layout
from roma_tpu_torch.models.tiny import TinyRoMaNet
from roma_tpu_torch.ops import batched_grid
from roma_tpu_torch.train import (
    TinyRobustLosses,
    bce_with_logits_masked,
    get_gt_warp,
    in_encoder,
    make_optimizer,
    make_train_step,
    mutual_nearest_mask,
)
from torch_port_fixtures import port_tiny_net, seeded_tiny_roma_variables

B, HW = 2, 64
CONFIGS = {"default": {}, "gated": dict(epe_mask_prob_th=0.001, cert_only_on_consistent_depth=True,
                                        local_dist=((4, 8.0),))}


def pose_batch(b, hw, seed):
    """A surface at depth ~4 with a 5% bump, holes in A's depth, and a
    sideways shift of one coarse cell (8 pixels at depth 4): the GT warp
    lands within the mutual-nearest threshold of a cell centre where the
    bump is low and outside it where it is high. Images from the seed."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    d0 = np.repeat((4.0 * (1 + 0.05 * np.sin(xx / 9.0) * np.cos(yy / 7.0)))[None], b, 0).astype(np.float32)
    d0[:, :3, :3] = 0
    f = 0.8 * hw
    K = np.tile(np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 0, 3] = (hw / 8) * 4.0 / f
    return {"im_A": rs.rand(b, hw, hw, 3).astype(np.float32), "im_B": rs.rand(b, hw, hw, 3).astype(np.float32),
            "im_A_depth": d0, "im_B_depth": d0.copy(), "T_1to2": T, "K1": K, "K2": K.copy()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_bce_with_logits_masked_matches_jax():
    rs = np.random.RandomState(0)
    z, t, m = rs.randn(3, 40).astype(np.float32) * 3, rs.rand(3, 40).astype(np.float32), rs.rand(3, 40) > 0.5
    for mask in (None, m):
        got = bce_with_logits_masked(torch.from_numpy(z), torch.from_numpy(t),
                                     None if mask is None else torch.from_numpy(mask))
        want = jax_bce(jnp.asarray(z), jnp.asarray(t), None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mutual_nearest_mask_matches_jax():
    batch = pose_batch(B, HW, seed=1)
    h = w = 8
    x2, _ = get_gt_warp(*(torch.from_numpy(batch[k]) for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")),
                        H=h, W=w)
    t_inv = torch.linalg.inv(torch.from_numpy(batch["T_1to2"]))
    back, _ = get_gt_warp(torch.from_numpy(batch["im_B_depth"]), torch.from_numpy(batch["im_A_depth"]), t_inv,
                          torch.from_numpy(batch["K2"]), torch.from_numpy(batch["K1"]), H=h, W=w)
    grid = batched_grid(1, h, w)[0].reshape(-1, 2)
    got = mutual_nearest_mask(x2.reshape(B, -1, 2), back.reshape(B, -1, 2), grid)
    want = jax_mnn(jnp.asarray(x2.reshape(B, -1, 2).numpy()), jnp.asarray(back.reshape(B, -1, 2).numpy()),
                   jax_batched_grid(1, h, w)[0].reshape(-1, 2))
    assert got.shape == (B, h * w, h * w) and 0.2 < got.sum().item() / (B * h * w) <= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("config", CONFIGS)
def test_losses_match_jax(config):
    rs = np.random.RandomState(2)
    batch = pose_batch(B, HW, seed=3)
    corresps = {}
    for s, hw in ((8, 8), (4, 16)):  # predictions near the GT warp
        g, _ = jax_get_gt_warp(*(jnp.asarray(batch[k]) for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")),
                               H=hw, W=hw)
        corresps[s] = {"flow": (np.asarray(g) + 0.004 * s * rs.randn(B, hw, hw, 2)).astype(np.float32),
                       "certainty": rs.randn(B, hw, hw, 1).astype(np.float32)}
    corresps[8]["corr_volume"] = rs.randn(B, 64, 64).astype(np.float32)
    kw = CONFIGS[config]
    jl, jm = jax.jit(JaxTinyLosses(**kw))({s: {k: jnp.asarray(v) for k, v in d.items()} for s, d in corresps.items()},
                                          _j(batch))
    tl, tm = TinyRobustLosses(**kw)({s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in corresps.items()},
                                    _t(batch))
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert tm["gm_corr_volume_loss_8"].item() > 0
    assert all(tm[f"delta_regression_loss_{s}"].item() > 0 for s in (8, 4))


# --- one training step against the JAX package --------------------------------

LRS = dict(encoder_lr=0.0, decoder_lr=1e-4, milestones=(100,))


@pytest.fixture(scope="module")
def jax_step():
    variables = seeded_tiny_roma_variables(1)
    batch = pose_batch(B, HW, seed=4)
    net = JaxTinyRoMaNet(train_mode=True, freeze_xfeat=True)

    def loss_fn(params, stats):
        corresps, mut = net.apply({"params": params, "batch_stats": stats}, jnp.asarray(batch["im_A"]),
                                  jnp.asarray(batch["im_B"]), mutable=["batch_stats"])
        loss, metrics = JaxTinyLosses()(corresps, _j(batch))
        return loss, (metrics, mut["batch_stats"])

    (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return dict(variables=variables, batch=batch, loss=float(loss), metrics=jax.device_get(metrics),
                grads=jax.device_get(grads), stats=jax.device_get(stats))


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's step on the same inputs, recording each BatchNorm's rows
    and each gradient as backward left it (the step then clips it)."""
    net = port_tiny_net(jax_step["variables"], train_mode=True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    raw = {}
    for name, p in net.named_parameters():
        p.register_post_accumulate_grad_hook(lambda p, name=name: raw.__setitem__(name, p.grad.clone()))
    seen = {}
    for name, mod in net.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, a, name=name: seen.setdefault(name, []).append((a[0].numel() // a[0].shape[1], m.training)))
    opt = make_optimizer(net, **LRS)
    step = make_train_step(net, TinyRobustLosses(), opt)
    metrics = step(_t(jax_step["batch"]))
    return dict(net=net, before=before, raw=raw, seen=seen, metrics=metrics, opt=opt)


def test_train_step_loss_matches_jax(jax_step, port_step):
    m, jm = port_step["metrics"], jax_step["metrics"]
    np.testing.assert_allclose(m["loss"].item(), jax_step["loss"], rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert m["gm_corr_volume_loss_8"].item() > 0 and m["nonfinite_grads"].item() == 0
    assert m["grad_norm_encoder"].item() == 0 and m["grad_norm_decoder"].item() > 0


def test_train_step_gradients_match_jax(jax_step, port_step):
    jg = to_port_layout({"params": jax_step["grads"]})
    raw = port_step["raw"]
    assert sorted(raw) == sorted(k for k in jg if not in_encoder(k))  # XFeat's outputs are detached
    for name, ref in jg.items():
        if in_encoder(name):
            assert not ref.any(), name
            continue
        np.testing.assert_allclose(raw[name].numpy(), ref, atol=1e-3 * np.abs(ref).max(), rtol=0, err_msg=name)


def test_train_step_bn_stats_match_jax_and_xfeat_stays_frozen(jax_step, port_step):
    net, before, seen = port_step["net"], port_step["before"], port_step["seen"]
    sd = net.state_dict()
    stats = to_port_layout({"batch_stats": jax_step["stats"]})
    for name, calls in seen.items():
        (n, training), = set(calls)
        if name.startswith("xfeat."):
            assert not training, name
            for k in ("running_mean", "running_var"):
                assert torch.equal(sd[f"{name}.{k}"], before[f"{name}.{k}"]), name
            continue
        assert training and len(calls) == 1, name
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(), stats[f"{name}.running_mean"],
                                   atol=1e-5, rtol=0, err_msg=name)
        v0 = before[f"{name}.running_var"].numpy()
        keep = 1 - 0.1
        want = keep * v0 + (stats[f"{name}.running_var"] - keep * v0) * n / (n - 1)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), want, atol=1e-5, rtol=0, err_msg=name)
    assert len([k for k in seen if not k.startswith("xfeat.")]) == 8
    assert net.training and not net.xfeat.training
    for name, p in net.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved != in_encoder(name), name
    # XFeat's 18 convs, skip1 and the fusion head in the encoder group; the matchers' 4 convs and head each
    assert [len(g["params"]) for g in port_step["opt"].param_groups] == [18 + 2 + 2, 2 * (4 + 2)]


def test_a_few_steps_on_identity_pose_lower_the_loss():
    """tests/test_train_convergence.py on the port: the same image pair,
    identity pose, XFeat frozen."""
    torch.manual_seed(0)
    b, res = 8, 64
    net = TinyRoMaNet(train_mode=True, freeze_xfeat=True, exact_softmax=True)
    opt = make_optimizer(net, encoder_lr=0.0, decoder_lr=3e-4, milestones=(10_000,), grad_clip=1.0)
    step = make_train_step(net, TinyRobustLosses(epe_mask_prob_th=0.001), opt)
    rs = np.random.RandomState(0)
    im = rs.rand(b, res, res, 3).astype(np.float32)
    K = np.tile(np.array([[60.0, 0, res / 2], [0, 60.0, res / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    batch = _t({"im_A": im, "im_B": im, "im_A_depth": rs.rand(b, res, res).astype(np.float32) * 5 + 2,
                "im_B_depth": rs.rand(b, res, res).astype(np.float32) * 5 + 2,
                "T_1to2": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)), "K1": K, "K2": K})
    losses = [step(batch)["loss"].item() for _ in range(6)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
