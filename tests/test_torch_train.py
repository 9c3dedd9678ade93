"""The port's training slice (roma_tpu_torch.train, RoMaNet in training
mode) against the JAX package's, float32 on the CPU, from numpy seeds: the
GT warp in its three depth modes, the robust losses, one optimizer step
against optax, the EMA ramp, the checkpoint round trip, and one
RoMaConfig.tiny() train step with the same weights, batch and peaked anchor
bias on both sides (loss, every gradient leaf, BatchNorm running stats and
parameters after the step). Also the two repairs of the port against the
JAX API: ``sample(key=)`` and ``RoMaNet(symmetric=)``."""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu.train import RobustLosses as JaxLosses
from roma_tpu.train import make_optimizer as jax_make_optimizer
from roma_tpu.train.gt_warp import get_gt_warp as jax_get_gt_warp
from roma_tpu.train.gt_warp import warp_kpts as jax_warp_kpts
from roma_tpu.train.train import ema_decay_schedule as jax_ema_schedule
from roma_tpu.train.train import make_ema_update as jax_make_ema_update
from roma_tpu_torch.models import RoMaConfig, roma_outdoor
from roma_tpu_torch.models.convert import to_port_layout
from roma_tpu_torch.ops import KERNEL_WRAPPERS
from roma_tpu_torch.train import (
    CheckPoint,
    RobustLosses,
    TrainState,
    ema_decay_schedule,
    get_gt_warp,
    init_train_state,
    make_ema_update,
    make_optimizer,
    make_train_step,
    train_k_steps,
    warp_kpts,
)
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from fullres_parity import render_peaked_bias  # noqa: E402
from torch_port_fixtures import one_thread  # noqa: E402, F401 (autouse: one torch thread)

MODES = ["bilinear", "nearest-exact", "combined"]


def _pose_batch(b, h, w, seed):
    """Smooth depths, B's disagreeing with A's in a band and noisy elsewhere,
    holes, and a small rotation + translation."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d0 = np.repeat((4.0 + np.sin(xx / 7.0) * np.cos(yy / 5.0))[None], b, 0)
    d1 = d0 * (1 + 0.04 * rs.randn(b, h, w))
    d1[:, :, : w // 4] *= 1.5
    d0[:, :2, :2] = 0
    d0, d1 = d0.astype(np.float32), d1.astype(np.float32)
    K = np.tile(np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    a = 0.05
    T[:, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:, 0, 3] = 0.1
    return d0, d1, T, K


def _smooth_batch(b, h, w, seed):
    """The training phase's synthetic batch: one smooth positive depth map
    for A and B, identity pose, pinhole K, so the GT warp is the identity
    and valid over the whole image."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 3.0 + 0.5 * np.sin(xx / w * rs.uniform(2, 4)) * np.cos(yy / h * rs.uniform(2, 4))
    depth = np.repeat(depth[None], b, 0).astype(np.float32)
    K = np.tile(np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    return {"im_A_depth": depth, "im_B_depth": depth.copy(), "T_1to2": T, "K1": K, "K2": K.copy()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", MODES)
def test_warp_kpts_and_gt_warp_match_jax(mode):
    b, h, w = 2, 24, 32
    d0, d1, T, K = _pose_batch(b, h, w, seed=0)
    kpts = np.random.RandomState(1).uniform(-0.95, 0.95, (b, 77, 2)).astype(np.float32)
    args = (kpts, d0, d1, T, K, K)
    vj, wj = jax_warp_kpts(*map(jnp.asarray, args), depth_interpolation_mode=mode)
    vt, wt = warp_kpts(*map(torch.from_numpy, args), depth_interpolation_mode=mode)
    vj, wj = np.asarray(vj), np.asarray(wj)
    assert 0.2 < vj.mean() < 0.9
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_allclose(wt.numpy(), wj, atol=1e-5)

    xj, pj = jax_get_gt_warp(*map(jnp.asarray, (d0, d1, T, K, K)), depth_interpolation_mode=mode, H=12, W=16)
    xt, pt = get_gt_warp(*map(torch.from_numpy, (d0, d1, T, K, K)), depth_interpolation_mode=mode, H=12, W=16)
    assert xt.shape == (b, 12, 16, 2) and pt.shape == (b, 12, 16)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)


def _corresps(b, rs):
    """Predictions near the identity GT warp, so the EPE gating keeps some
    supervision at every scale."""
    out = {}
    for s, hw in ((16, 4), (8, 8), (4, 16), (2, 16), (1, 32)):
        g = np.stack(np.meshgrid(np.linspace(-1 + 1 / hw, 1 - 1 / hw, hw),
                                 np.linspace(-1 + 1 / hw, 1 - 1 / hw, hw), indexing="xy"), -1)
        out[s] = {"flow": (g[None] + 0.004 * s * rs.randn(b, hw, hw, 2)).astype(np.float32),
                  "certainty": rs.randn(b, hw, hw, 1).astype(np.float32)}
    out[16]["gm_cls"] = rs.randn(b, 4, 4, 16 * 16).astype(np.float32) * 2
    out[16]["gm_certainty"] = rs.randn(b, 4, 4, 1).astype(np.float32)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_robust_losses_match_jax(mode):
    b = 2
    rs = np.random.RandomState(3)
    batch = _smooth_batch(b, 32, 32, seed=4)
    corr = _corresps(b, rs)
    jl, jm = jax.jit(JaxLosses(depth_interpolation_mode=mode))(
        {s: {k: jnp.asarray(v) for k, v in d.items()} for s, d in corr.items()}, _j(batch))
    tl, tm = RobustLosses(depth_interpolation_mode=mode)(
        {s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in corr.items()}, _t(batch))
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    # every term is active: the gating leaves some supervision at each scale
    assert all(tm[f"delta_regression_loss_{s}"].item() > 0 for s in (8, 4, 2, 1))


class _Tree(nn.Module):
    """A small parameter tree with the RoMaNet top-level layout."""

    def __init__(self, rs):
        super().__init__()
        p = lambda *s: nn.Parameter(torch.from_numpy(rs.randn(*s).astype(np.float32)))
        self.encoder = nn.Module()
        self.encoder.w = p(3, 4)
        self.encoder.dinov2 = nn.Module()
        self.encoder.dinov2.w = p(5)
        self.encoder.dinov2.requires_grad_(False)
        self.decoder = nn.Module()
        self.decoder.w = p(4, 1)
        self.decoder.b = p(2)

    def jax_tree(self):
        return {"encoder": {"w": self.encoder.w, "dinov2": {"w": self.encoder.dinov2.w}},
                "decoder": {"w": self.decoder.w, "b": self.decoder.b}}


def test_optimizer_steps_match_optax():
    rs = np.random.RandomState(0)
    net = _Tree(rs)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), net.jax_tree())
    kw = dict(encoder_lr=3e-3, decoder_lr=2e-2, milestones=(2,), warmup_steps=2)
    jopt = jax_make_optimizer(**kw)
    jstate = jopt.init(jtree)
    opt = make_optimizer(net, **kw)
    frozen = net.encoder.dinov2.w.detach().clone()
    assert sum(len(g["params"]) for g in opt.param_groups) == 3  # DINOv2 absent
    for step in range(4):
        grads = jax.tree.map(lambda t: rs.randn(*t.shape).astype(np.float32), jtree)
        grads["encoder"]["dinov2"]["w"] = np.zeros_like(grads["encoder"]["dinov2"]["w"])
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jtree)
        jtree = optax.apply_updates(jtree, upd)
        for (name, p), g in zip(_named(net), _named_tree(grads)):
            if p.requires_grad:
                p.grad = torch.from_numpy(g)
        opt.step()
        for (name, p), ref in zip(_named(net), _named_tree(jtree)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), atol=1e-6,
                                       err_msg=f"{name} step {step}")
    assert torch.equal(net.encoder.dinov2.w, frozen)
    assert not opt.adamw.state.get(net.encoder.dinov2.w)


def _named(net):
    return [("encoder.w", net.encoder.w), ("encoder.dinov2.w", net.encoder.dinov2.w),
            ("decoder.w", net.decoder.w), ("decoder.b", net.decoder.b)]


def _named_tree(t):
    return [t["encoder"]["w"], t["encoder"]["dinov2"]["w"], t["decoder"]["w"], t["decoder"]["b"]]


def test_ema_ramp_matches_jax_and_train_k_steps_keeps_it():
    for step in (0, 1, 5, 100, 10_000):
        assert ema_decay_schedule(0.995, step) == pytest.approx(float(jax_ema_schedule(0.995, step)), rel=1e-6)
    rs = np.random.RandomState(1)
    ema = {"w": rs.randn(4).astype(np.float32)}
    params = [{"w": rs.randn(4).astype(np.float32)} for _ in range(3)]
    jup, tup = jax_make_ema_update(0.9), make_ema_update(0.9)
    je, te = {"w": jnp.asarray(ema["w"])}, {"w": torch.from_numpy(ema["w"].copy())}
    for t, p in enumerate(params):
        je = jup(je, {"w": jnp.asarray(p["w"])}, t)
        tup(te, {"w": torch.from_numpy(p["w"])}, t)
        np.testing.assert_allclose(te["w"].numpy(), np.asarray(je["w"]), rtol=1e-6)

    # one step of a least-squares "model": EMA = 0.1 init + 0.9 params_1
    net = _Tree(rs)
    init = net.decoder.w.detach().clone()
    x = torch.from_numpy(rs.randn(16, 4).astype(np.float32))
    y = x @ torch.tensor([[1.0], [-2.0], [0.5], [3.0]])
    opt = make_optimizer(net, 0.1, 0.1, ())
    step = make_train_step(net, lambda out, b: (((out - b["y"]) ** 2).mean(), {}), opt,
                           forward=lambda n, b: b["x"] @ n.decoder.w)
    state = init_train_state(net, opt)
    state, metrics = train_k_steps(state, [{"x": x, "y": y}], step, ema_decay=0.5)
    w1 = net.decoder.w.detach()
    torch.testing.assert_close(state.ema_params["decoder.w"], 0.1 * init + 0.9 * w1, rtol=1e-6, atol=1e-7)
    assert state.step == 1 and metrics["nonfinite_grads"].item() == 0
    for k in ("grad_norm", "param_norm", "grad_norm_encoder", "grad_norm_decoder", "loss"):
        assert torch.isfinite(metrics[k]), k


def test_checkpoint_round_trip(tmp_path):
    rs = np.random.RandomState(2)
    net = _Tree(rs)
    opt = make_optimizer(net, 1e-3, 1e-2, (5,))
    for p in (net.encoder.w, net.decoder.w, net.decoder.b):
        p.grad = torch.ones_like(p)
    opt.step()
    ema = {k: p.detach().clone() + 1 for k, p in net.named_parameters()}
    state = TrainState(net=net, optimizer=opt, step=7, ema_params=ema)
    ckpt = CheckPoint(str(tmp_path), "test")
    assert ckpt.load(TrainState(net=_Tree(rs), optimizer=None)).step == 0  # nothing saved yet
    for s in (5, 6, 7):
        state.step = s
        ckpt.save(state)
    assert sorted(f.name for f in (tmp_path / "test").iterdir()) == ["step_6.pt", "step_7.pt"]

    net2 = _Tree(np.random.RandomState(9))
    opt2 = make_optimizer(net2, 1e-3, 1e-2, (5,))
    state2 = ckpt.load(TrainState(net=net2, optimizer=opt2))
    assert state2.step == 7 and opt2.count == 1
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), k
    torch.testing.assert_close(opt2.state_dict()["adamw"]["state"], opt.state_dict()["adamw"]["state"])
    assert all(torch.equal(ema[k], state2.ema_params[k]) for k in ema)


# --- the tiny-config train step against the JAX package ---------------------

B, HW = 2, 56
LRS = dict(encoder_lr=B * 5e-6 / 8, decoder_lr=B * 1e-4 / 8, milestones=(100,))


def _images(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, HW, HW, 3) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step():
    """One compiled JAX train step at the tiny config: loss, metrics,
    gradients, BatchNorm stats and parameters after one optax update."""
    variables = seeded_tiny_variables(0)
    im_a, im_b = _images(1), _images(2)
    # with random weights the coarse argmax of cls_to_flow_refine has
    # near-ties, and one flip makes the two sides' losses and gradients
    # diverge; the peaked anchor bias keeps it off them
    bias = render_peaked_bias(HW // 14, HW // 14, cls_res=TINY.cls_res, batch=B)
    batch = _smooth_batch(B, HW, HW, seed=3)
    net = JaxNet(config=TINY, train_mode=True)

    def loss_fn(params, stats):
        corresps, mut = net.apply({"params": params, "batch_stats": stats}, jnp.asarray(im_a),
                                  jnp.asarray(im_b), gm_logit_bias=jnp.asarray(bias),
                                  mutable=["batch_stats"])
        loss, metrics = JaxLosses()(corresps, _j(batch))
        return loss, (metrics, mut["batch_stats"])

    (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    new_params = _jax_update(grads, variables["params"])
    return dict(variables=variables, im_a=im_a, im_b=im_b, bias=bias, batch=batch,
                loss=float(loss), metrics=jax.device_get(metrics), grads=jax.device_get(grads),
                stats=jax.device_get(stats), params=jax.device_get(new_params))


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's step on the same inputs, recording how many rows each
    BatchNorm normalized and how many times it ran, and each gradient as
    backward left it (the step then clips it in place)."""
    js = jax_step
    net = port_net(js["variables"]).train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    raw = {}
    for name, p in net.named_parameters():
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(lambda p, name=name: raw.__setitem__(name, p.grad.clone()))
    seen = {}
    for name, mod in net.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, a, name=name: seen.setdefault(name, []).append(a[0].numel() // a[0].shape[1]))
    opt = make_optimizer(net, **LRS)
    bias = torch.from_numpy(js["bias"])
    step = make_train_step(net, RobustLosses(), opt,
                           forward=lambda n, b: n(b["im_A"], b["im_B"], gm_logit_bias=bias))
    batch = dict(_t(js["batch"]), im_A=torch.from_numpy(js["im_a"]), im_B=torch.from_numpy(js["im_b"]))
    metrics = step(batch)
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)
    return dict(net=net, before=before, seen=seen, metrics=metrics, raw=raw)


def test_tiny_train_step_loss_matches_jax(jax_step, port_step):
    m, jm = port_step["metrics"], jax_step["metrics"]
    np.testing.assert_allclose(m["loss"].item(), jax_step["loss"], rtol=1e-4)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert m["gm_cls_loss_16"].item() > 0 and m["delta_regression_loss_1"].item() > 0
    flat = jax.tree_util.tree_leaves(jax_step["grads"])
    jnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in flat))
    np.testing.assert_allclose(m["grad_norm"].item(), jnorm, rtol=1e-4)
    assert m["nonfinite_grads"].item() == 0


# ReLU kinks: an activation within float32 noise of 0 takes the other
# branch on the other side, which moves the gradients of the layers around it
# by a few percent of their own largest entry (the port against itself at 1
# and at 8 CPU threads: 3% on the scale-4 refiner's leaves at this config).
# So every leaf is held to 1e-3 of the largest gradient entry of the whole
# model, and the leaves no ReLU mask reaches in practice (TransformerDecoder
# and GP, whose backward meets only scale 16's 32 refiner pixels) to 1e-3 of
# their own largest entry. The conv biases in front of a BatchNorm have an
# exact gradient of 0, which float noise replaces on both sides.
KINK_FREE = ("decoder.embedding_decoder.", "decoder.gps.")


def _biases_before_bn(net):
    """Names of the conv biases a train-mode BatchNorm cancels."""
    out = set()
    for name, mod in net.named_modules():
        kids = list(mod.named_children())
        for (a, conv), (_, bn) in zip(kids, kids[1:]):
            if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                out.add(f"{name}.{a}.bias")
    return out


def test_tiny_train_step_gradients_match_jax(jax_step, port_step):
    """p.grad after the step holds the clipped gradient: compare with JAX's
    gradient clipped by the same rule (0.01 / max(norm, 0.01))."""
    jg = to_port_layout({"params": jax_step["grads"]})
    jnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in jg.values()))
    clip = 0.01 / max(jnorm, 0.01)
    gmax = clip * max(np.abs(g).max() for g in jg.values())
    zero = _biases_before_bn(port_step["net"])
    assert len(zero) == sum(len(s) for s in TINY.vgg_channels) + 5 + 5 * (1 + TINY.hidden_blocks)
    n_own = 0
    for name, p in port_step["net"].named_parameters():
        ref = jg[name] * clip
        if not p.requires_grad:
            assert name.startswith("encoder.dinov2.") and not ref.any()
            continue
        if name in zero:
            assert max(np.abs(ref).max(), p.grad.abs().max().item()) < 1e-5 * gmax, name
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-3 * gmax, rtol=0, err_msg=name)
        if name.startswith(KINK_FREE):
            np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-3 * np.abs(ref).max(), rtol=0,
                                       err_msg=name)
            n_own += 1
    assert n_own == 11 * TINY.decoder_depth + 4  # 11 tensors a block, to_out, pos_conv
    # the decoder is reached through scale 16's flow, whose graph is kept
    td = [p.grad for k, p in port_step["net"].named_parameters() if "embedding_decoder.blocks" in k]
    assert td and all(g.abs().max() > 0 for g in td)


def test_tiny_train_step_bn_stats_and_params_match_jax(jax_step, port_step):
    """Running means move identically; running variances differ by torch's
    unbiased N/(N-1) on each batch variance (tests/test_bn_semantics.py).
    Parameters: the port's step must apply the recipe's optax update to the
    port's own gradient to 1e-6. Against JAX's step, AdamW's first update
    lr * g / (|g| + 1e-8) turns the clipped gradient's entries near 1e-8
    into most of a step, so an entry beside a ReLU kink (see above) or a
    conv bias in front of a BatchNorm, whose gradient is float noise, may
    differ by up to two learning rates; the kink-free and frozen leaves hold
    to 1e-6."""
    sd, before, seen = port_step["net"].state_dict(), port_step["before"], port_step["seen"]
    stats = to_port_layout({"batch_stats": jax_step["stats"]})
    mods = dict(port_step["net"].named_modules())
    assert len(seen) == len(stats) // 2
    for name, rows in seen.items():
        assert len(set(rows)) == 1 and len(rows) == (2 if ".proj." in name else 1), (name, rows)
        n, k = rows[0], len(rows)
        # torch momentum m is flax momentum 1 - m (0.1 for torch_bn, 0.01
        # for the refiner blocks); the projection BNs run twice a step
        keep = (1 - mods[name].momentum) ** k
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(), stats[f"{name}.running_mean"],
                                   atol=1e-5, rtol=0, err_msg=name)
        v0 = before[f"{name}.running_var"].numpy()
        want = keep * v0 + (stats[f"{name}.running_var"] - keep * v0) * n / (n - 1)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), want, atol=1e-5, rtol=0, err_msg=name)
    net = port_step["net"]
    own = _nest({k: before[k].numpy() for k, _ in net.named_parameters()})
    raw = _nest({k: port_step["raw"].get(k, torch.zeros_like(p)).numpy() for k, p in net.named_parameters()})
    own = _flat(jax.device_get(_jax_update(raw, own)))
    params = to_port_layout({"params": jax_step["params"]})
    for name, p in net.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, own[name], atol=1e-6, rtol=0, err_msg=name)
        if not p.requires_grad:
            assert torch.equal(p.detach(), before[name])
        if not p.requires_grad or name.startswith(KINK_FREE):
            np.testing.assert_allclose(got, params[name], atol=1e-6, rtol=0, err_msg=name)
        lr = LRS["encoder_lr" if name.startswith("encoder.") else "decoder_lr"]
        np.testing.assert_allclose(got, params[name], atol=2 * lr, rtol=0, err_msg=name)


@jax.jit
def _jax_update(grads, params):
    """Parameters after one step of the recipe's optax optimizer."""
    opt = jax_make_optimizer(**LRS)
    upd, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, upd)


def _nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}, the tree optax's labels read."""
    out: dict = {}
    for k, v in flat.items():
        *path, last = k.split(".")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


# --- repairs of the port against the JAX API --------------------------------

def test_sample_takes_a_key():
    m = roma_outdoor(device="cpu", amp=False, coarse_res=56, upsample_res=64, config=RoMaConfig.tiny())
    rs = np.random.RandomState(0)
    warp = torch.from_numpy(rs.uniform(-1, 1, (64, 128, 4)).astype(np.float32))
    cert = torch.from_numpy(rs.uniform(0, 1, (64, 128)).astype(np.float32))
    a1, c1 = m.sample(warp, cert, num=100, key=3)
    a2, _ = m.sample(warp, cert, num=100, key=3)
    b1, _ = m.sample(warp, cert, num=100, key=torch.Generator().manual_seed(4))
    g1, _ = m.sample(warp, cert, num=100, generator=torch.Generator().manual_seed(4))
    assert a1.shape == (100, 4) and c1.shape == (100,)
    assert torch.equal(a1, a2) and torch.equal(b1, g1) and not torch.equal(a1, b1)
    with pytest.raises(ValueError):
        m.sample(warp, cert, num=10, key=1, generator=torch.Generator())


def test_cached_tensors_made_in_inference_mode_train():
    """Grids and resize matrices are cached per device; the first request
    may come from the matcher's inference_mode, and a later training step
    must still be able to save them for backward."""
    from roma_tpu_torch.ops import interpolate, normalized_grid

    with torch.inference_mode():
        normalized_grid(5, 7)
        interpolate(torch.zeros(1, 5, 7, 1), (9, 11))
    w = torch.ones(5, 7, 2, requires_grad=True)
    (normalized_grid(5, 7) * w).sum().backward()
    x = torch.ones(1, 5, 7, 1, requires_grad=True)
    interpolate(x, (9, 11)).square().sum().backward()
    assert w.grad is not None and x.grad is not None


def test_roma_net_defaults_to_non_symmetric(jax_step):
    variables = jax_step["variables"]
    net = port_net(variables)
    a, b = jax_step["im_a"][:1], jax_step["im_b"][:1]
    jc = jax.jit(JaxNet(config=TINY).apply)(variables, jnp.asarray(a), jnp.asarray(b), scale_factor=0.1)
    with torch.no_grad():
        tc = net(torch.from_numpy(a), torch.from_numpy(b), scale_factor=0.1)
        sym = net(torch.from_numpy(a), torch.from_numpy(b), symmetric=True, scale_factor=0.1)
    for s in (16, 8, 4, 2, 1):
        for k in ("flow", "certainty"):
            assert tc[s][k].shape[0] == 1 and sym[s][k].shape[0] == 2
            np.testing.assert_allclose(tc[s][k].numpy(), np.asarray(jc[s][k]), atol=2e-3)
            np.testing.assert_allclose(tc[s][k].numpy(), sym[s][k][:1].numpy(), atol=1e-5)
