"""The port's synthetic convergence run (roma_tpu_torch/tools/convergence_run.py)
against the JAX tool (tools/convergence_run.py) on the CPU: the analytic
pairs bit for bit on the same RandomState, drawn in turn and rendered in
turn or on threads; ``dense_pck`` on the same flow and
batch (PCK fractions to one pixel in the valid set, EPE to rtol 1e-5: the
GT warps agree to tests/test_torch_train.py's 1e-5); three steps of the
tool's recipe at RoMaConfig.tiny(), 56^2, batch 2, on the same weights
(models/convert.py) and the tool's pairs, against one jitted JAX step
(``mesh=None``): each step's loss and metrics at test_torch_train.py's bars
(rtol 1e-4), and the warmup-ramped EMA after them; and ``main`` at
``--device cpu`` writing a report with the JAX report's keys.

Both sides add the peaked anchor bias of test_torch_train.py to the coarse
logits: with random weights the coarse argmax has near-ties, and one flip
would make the two sides' losses diverge."""
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu.train import RobustLosses as JaxLosses
from roma_tpu.train import make_optimizer as jax_make_optimizer
from roma_tpu.train import make_train_step as jax_make_train_step
from roma_tpu.train.gt_warp import get_gt_warp as jax_gt
from roma_tpu.train.train import make_ema_update as jax_make_ema_update
from roma_tpu_torch.models.convert import to_port_layout
from roma_tpu_torch.ops import KERNEL_WRAPPERS
from roma_tpu_torch.tools import convergence_run as conv
from roma_tpu_torch.train import make_ema_update, make_train_step
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import convergence_run as jax_conv  # noqa: E402
from fullres_parity import render_peaked_bias  # noqa: E402

B, RES, STEPS = 2, 56, 3


@pytest.mark.parametrize("threads", [0, 2], ids=["in turn", "rendered on 2 threads"])
@pytest.mark.parametrize("seed", [0, 999])
def test_pairs_equal_jax_bit_for_bit(seed, threads):
    rs = np.random.RandomState(seed)
    if threads:
        with ThreadPoolExecutor(threads) as pool:
            got = conv.make_batch(rs, 2, 64, pool)
    else:
        got = conv.make_batch(rs, 2, 64)
    want = jax_conv.make_batch(np.random.RandomState(seed), 2, 64)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("noise", [0.002, 0.02], ids=["close", "far"])
def test_dense_pck_equals_jax(noise):
    batch = conv.make_batch(np.random.RandomState(7), 2, 48)
    gt, _ = jax_gt(batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"], batch["K1"], batch["K2"], H=48, W=48)
    flow = (np.asarray(gt) + noise * np.random.RandomState(8).randn(2, 48, 48, 2)).astype(np.float32)
    (got, got_epe) = conv.dense_pck({1: {"flow": torch.from_numpy(flow)}}, batch)
    (want, want_epe) = jax_conv.dense_pck({1: {"flow": flow}}, batch)
    assert got.keys() == want.keys() == {"pck_1", "pck_3", "pck_5"}
    n_valid = 2 * 48 * 48
    for k in want:
        assert abs(got[k] - want[k]) <= 1.0 / n_valid * 1.01 or got[k] == want[k], (k, got[k], want[k])
    assert 0 < want["pck_1"] < 1 or noise < 0.01
    np.testing.assert_allclose(got_epe, want_epe, rtol=1e-5)


@pytest.fixture(scope="module")
def runs():
    """Three steps of the tool's recipe on each side, same weights, pairs
    and bias: the metrics of each step, the EMA after the last, and the
    parameters before the first."""
    variables = seeded_tiny_variables(0)
    bias = render_peaked_bias(RES // 14, RES // 14, cls_res=TINY.cls_res, batch=B)
    rs = np.random.RandomState(0)
    batches = [conv.make_batch(rs, B, RES) for _ in range(STEPS)]

    net = JaxNet(config=TINY, train_mode=True)

    def apply_fn(v, batch):
        corresps, mut = net.apply(v, batch["im_A"], batch["im_B"], gm_logit_bias=jnp.asarray(bias),
                                  mutable=["batch_stats"])
        return corresps, mut["batch_stats"]

    l = conv.LOSSES
    objective = JaxLosses(ce_weight=l.ce_weight, local_dist=l.local_dist, local_largest_scale=l.local_largest_scale,
                          alpha=l.alpha, c=l.c)
    opt = jax_make_optimizer(encoder_lr=conv.ENCODER_LR, decoder_lr=conv.DECODER_LR,
                             milestones=(int(0.9 * STEPS),), grad_clip=conv.GRAD_CLIP,
                             warmup_steps=conv.WARMUP_STEPS)
    jstep = jax_make_train_step(apply_fn, objective, opt, mesh=None)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = opt.init(params)
    jema = jax.tree.map(lambda p: jnp.asarray(p, jnp.float32), params)
    jupdate = jax_make_ema_update(conv.EMA_DECAY)
    jax_metrics = []
    for i, batch in enumerate(batches):
        params, stats, opt_state, m = jstep(params, stats, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        jema = jupdate(jema, params, i)
        jax_metrics.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})

    tnet = port_net(variables).train()
    before = {k: p.detach().clone() for k, p in tnet.named_parameters()}
    tbias = torch.from_numpy(bias)
    tstep = make_train_step(tnet, conv.LOSSES, conv.optimizer(tnet, STEPS),
                            forward=lambda n, b: n(b["im_A"], b["im_B"], gm_logit_bias=tbias))
    tparams = dict(tnet.named_parameters())
    tema = {k: p.detach().float().clone() for k, p in tparams.items()}
    flat = {k: v.clone() for k, v in tema.items()}  # a planted fault: the EMA without its warmup ramp
    tupdate, flat_update = make_ema_update(conv.EMA_DECAY), make_ema_update(conv.EMA_DECAY, warmup=False)
    port_metrics = []
    for i, batch in enumerate(batches):
        m = tstep(conv.to_device(batch, "cpu"))
        tupdate(tema, tparams, i)
        flat_update(flat, tparams, i)
        port_metrics.append({k: v.item() for k, v in m.items() if v.dim() == 0})
    return dict(port=port_metrics, jax=jax_metrics, port_ema=tema, flat_ema=flat,
                jax_ema=to_port_layout({"params": jema}), before=before)


def test_three_steps_losses_match_jax(runs):
    """Every loss term and train_pck_05 at test_torch_train.py's bars
    (rtol 1e-4, atol 1e-6), each step; the gradient norm at its gradient
    bar, 1e-3. The per-group norms are not compared: after the first
    update, ReLU kinks (see test_torch_train.py) move the VGG encoder's
    group norm by up to 0.6% between any two float32 runs."""
    for i, (m, jm) in enumerate(zip(runs["port"], runs["jax"])):
        losses = [k for k in jm if "loss" in k or k == "train_pck_05"]
        assert "loss" in losses and "gm_cls_loss_16" in losses and "delta_regression_loss_1" in losses
        for k in losses:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=f"step {i + 1} {k}")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3, err_msg=f"step {i + 1}")
        assert m["nonfinite_grads"] == jm["nonfinite_grads"] == 0
    # the three pairs differ, so do the losses: the steps are not one step repeated
    assert len({round(m["loss"], 4) for m in runs["port"]}) == STEPS


def _lr_sum(steps: int) -> float:
    """The decoder's learning rates over the run's first ``steps`` updates
    (the larger group's)."""
    sched = conv.optimizer(torch.nn.Linear(1, 1), STEPS).schedules["decoder"]
    return sum(sched(i) for i in range(steps))


def test_ema_after_three_steps_matches_jax(runs):
    """Each EMA leaf within two learning rates a step of JAX's (the
    parameter bar of test_torch_train.py: AdamW's lr * g / (|g| + eps)
    turns a gradient entry beside a ReLU kink, or a conv bias's noise
    gradient in front of a BatchNorm, into up to a step either way), and
    the EMA's whole movement from the initial parameters, summed over every
    entry, to 1e-3 of JAX's. The EMA without its warmup ramp (decay 0.995
    from the first update, a planted fault) must miss that by far."""
    ema, jema, before = runs["port_ema"], runs["jax_ema"], runs["before"]
    assert ema.keys() == jema.keys()
    bar = 2 * _lr_sum(STEPS)
    for k in ema:
        np.testing.assert_allclose(ema[k].numpy(), jema[k], atol=bar, rtol=0, err_msg=k)

    def movement(e):
        return sum(float(np.abs(np.asarray(e[k], np.float64) - before[k].double().numpy()).sum()) for k in e)

    want = movement(jema)
    assert want > 0
    np.testing.assert_allclose(movement(ema), want, rtol=1e-3)
    assert abs(movement(runs["flat_ema"]) / want - 1) > 0.5


def test_main_writes_the_jax_reports_keys(tmp_path):
    report = conv.main(["--device", "cpu", "--steps", "2", "--res", "56", "--batch", "2", "--log_every", "1",
                        "--tag", "t"], out_dir=tmp_path)
    with open(os.path.join(ROOT, "CONVERGENCE_r05.json")) as f:
        jax_keys = set(json.load(f))
    with open(tmp_path / "CONVERGENCE_TORCH_t.json") as f:
        written = json.load(f)
    assert jax_keys <= set(written) and written == json.loads(json.dumps(report))
    steps = [json.loads(line) for line in open(tmp_path / "CONVERGENCE_TORCH_t.steps.jsonl")]
    assert [s["step"] for s in steps] == [1, 2]
    assert written["nonfinite_grad_steps"] == 0 and written["bn_stats_finite"] is True
    assert written["card"] is None and written["device"] == "cpu"
    assert written["launches"] == dict.fromkeys(written["launches"], 0)
    assert list(written["launches"]) == [f.__name__ for f in KERNEL_WRAPPERS]
    for k in ("eval_pck_before", "eval_pck_after", "eval_pck_after_ema"):
        assert set(written[k]) == {"pck_1", "pck_3", "pck_5"}
