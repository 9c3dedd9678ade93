"""Data parallelism (roma_tpu_torch.parallel, the collectives of
roma_tpu_torch.train.make_train_step) against the JAX package's sharded
step: two processes on gloo (torch.multiprocessing, spawned), each the
port's RoMaConfig.tiny() net at 56^2 with one row of a global batch of 2,
take 2 steps with the EMA; JAX's ``make_train_step(mesh=get_mesh(2))``
takes the same 2 steps on 2 CPU devices, same weights, batches and peaked
anchor bias. Bars, those of tests/test_torch_train.py: losses and metrics
rtol 1e-4; parameters 2 learning rates a step (1e-6 on the kink-free and
frozen leaves); BatchNorm running means 1e-5, running variances 1e-5 after
torch's unbiased N/(N-1) on each rank's batch variance; Adam's first
moments 1e-3 and second moments 2e-3 of their largest entry; the EMA as
the parameters. The ranks' parameters, statistics and moments are bitwise
equal, and a save/restore round trip gives the same params hash. Also the
single-process behaviour of the helpers (no process group, no collective)."""
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
import optax

from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu.parallel.mesh import get_mesh
from roma_tpu.train import RobustLosses as JaxLosses
from roma_tpu.train import init_train_state as jax_init_train_state
from roma_tpu.train import make_optimizer as jax_make_optimizer
from roma_tpu.train import make_train_step as jax_make_train_step
from roma_tpu.train.train import train_k_steps as jax_train_k_steps
from roma_tpu_torch.models.convert import to_port_layout
from roma_tpu_torch.parallel import dist
from torch_dist_worker import run, seeded_batch
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from fullres_parity import render_peaked_bias  # noqa: E402

WORLD, B, HW, STEPS = 2, 2, 56, 2
LRS = dict(encoder_lr=B * 5e-6 / 8, decoder_lr=B * 1e-4 / 8, milestones=(100,))
EMA = 0.99
KINK_FREE = ("decoder.embedding_decoder.", "decoder.gps.")  # see tests/test_torch_train.py


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    bias = render_peaked_bias(HW // 14, HW // 14, cls_res=TINY.cls_res, batch=B)
    batches = [dict(seeded_batch(B, HW, 10 + i), bias=bias) for i in range(STEPS)]
    return seeded_tiny_variables(0), batches


@pytest.fixture(scope="module")
def jax_run(inputs):
    """JAX's data-parallel step on a 2-device mesh: the state after each step."""
    variables, batches = inputs
    net = JaxNet(config=TINY, train_mode=True)

    def apply_fn(v, batch):
        corresps, mut = net.apply(v, batch["im_A"], batch["im_B"], gm_logit_bias=batch["bias"],
                                  mutable=["batch_stats"])
        return corresps, mut["batch_stats"]

    mesh = get_mesh(WORLD)
    optimizer = jax_make_optimizer(**LRS)
    step = jax_make_train_step(apply_fn, JaxLosses(), optimizer, mesh=mesh)
    state = jax_init_train_state(jax.tree.map(jnp.asarray, variables), optimizer, mesh=mesh)
    out = []
    for batch in batches:
        state, metrics = jax_train_k_steps(state, [batch], step, mesh=mesh, ema_decay=EMA)
        out.append(dict(metrics=jax.device_get(metrics), stats=to_port_layout({"batch_stats": jax.device_get(
            state.batch_stats)})))
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 2  # the encoder's and the decoder's

    def merged(field):
        full = [jax.tree.map(lambda p, m: np.zeros(p.shape, np.float32) if isinstance(m, optax.MaskedNode)
                             else np.asarray(m), state.params, getattr(s, field),
                             is_leaf=lambda x: isinstance(x, optax.MaskedNode)) for s in adam]
        return to_port_layout({"params": jax.tree.map(lambda a, b: a + b, *full)})

    return dict(steps=out, params=to_port_layout({"params": jax.device_get(state.params)}),
                ema=to_port_layout({"params": jax.device_get(state.ema_params)}), mu=merged("mu"), nu=merged("nu"))


@pytest.fixture(scope="module")
def port_run(inputs, tmp_path_factory):
    variables, batches = inputs
    out = tmp_path_factory.mktemp("dp")
    sd = {k: v.clone() for k, v in port_net(variables).state_dict().items()}
    mp.spawn(run, args=(WORLD, _free_port(), sd, batches, LRS, EMA, str(out)), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], sd


def test_ranks_agree_bitwise_and_restore(port_run):
    (r0, r1), _ = port_run
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for k in r0["stats"][-1]:
        assert torch.equal(r0["stats"][-1][k], r1["stats"][-1][k]), k
    for name, m in r0["moments"].items():
        assert all(torch.equal(v, r1["moments"][name][k]) for k, v in m.items()), name
    for r in (r0, r1):
        assert r["step"] == STEPS and r["restored_step"] == STEPS and r["restored_count"] == STEPS
        assert r["restored_hash"] == r["hash"] == r0["hash"]
        assert r["restored_ema_equal"] and r["restored_moments_equal"]
    # each rank normalized its own row of the global batch (A|B concatenated), not the pair
    assert r0["rows"]["encoder.cnn.layers.1"] == [2 * (B // WORLD) * HW * HW]


def test_losses_and_metrics_match_jax(port_run, jax_run):
    (r0, r1), _ = port_run
    for i, js in enumerate(jax_run["steps"]):
        jm = js["metrics"]
        for r in (r0, r1):
            m = r["metrics"][i]
            np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-4, err_msg=f"step {i}")
            for k, v in jm.items():
                if k in m and np.ndim(v) == 0:
                    np.testing.assert_allclose(m[k], float(v), rtol=1e-4, atol=1e-6, err_msg=f"{k} step {i}")
        assert r0["metrics"][i]["gm_cls_loss_16"] > 0 and r0["metrics"][i]["nonfinite_grads"] == 0


def test_params_and_ema_match_jax(port_run, jax_run):
    (r0, _), sd = port_run
    for name, p in r0["params"].items():
        got, want = p.numpy(), jax_run["params"][name]
        lr = LRS["encoder_lr" if name.startswith("encoder.") else "decoder_lr"]
        if name.startswith("encoder.dinov2."):
            assert torch.equal(p, sd[name]), name
        bar = 1e-6 if name.startswith(KINK_FREE + ("encoder.dinov2.",)) else 2 * lr * STEPS
        np.testing.assert_allclose(got, want, atol=bar, rtol=0, err_msg=name)
        np.testing.assert_allclose(r0["ema"][name].numpy(), jax_run["ema"][name], atol=bar, rtol=0, err_msg=name)
    moved = [k for k in r0["params"] if not torch.equal(r0["params"][k], sd[k])]
    assert moved and not any(k.startswith("encoder.dinov2.") for k in moved)


def test_bn_stats_match_jax(port_run, jax_run):
    """JAX's flax BatchNorm keeps the biased batch variance and the port's
    torch BatchNorm the unbiased one: with K = keep^calls a step and c =
    N/(N-1) for N rows a rank, the port's variance follows
    P_t = K P_(t-1) + c (J_t - K J_(t-1)) from JAX's J_t, both averaged over
    the ranks."""
    (r0, _), sd = port_run
    mods = dict(port_net(seeded_tiny_variables(0)).named_modules())
    prev_p = {k: v for k, v in sd.items() if "running_" in k}
    prev_j = dict(prev_p)
    for i, js in enumerate(jax_run["steps"]):
        got, want = r0["stats"][i], js["stats"]
        assert sorted(got) == sorted(want)
        for name, rows in r0["rows"].items():
            assert len(set(rows)) == 1
            keep = (1 - mods[name].momentum) ** len(rows)
            c = rows[0] / (rows[0] - 1)
            m, v = f"{name}.running_mean", f"{name}.running_var"
            np.testing.assert_allclose(got[m].numpy(), want[m], atol=1e-5, rtol=0, err_msg=f"{m} step {i}")
            expect = keep * prev_p[v].numpy() + c * (want[v] - keep * np.asarray(prev_j[v]))
            np.testing.assert_allclose(got[v].numpy(), expect, atol=1e-5, rtol=0, err_msg=f"{v} step {i}")
        prev_p, prev_j = got, {k: torch.from_numpy(np.array(x)) for k, x in want.items()}


def test_adam_moments_match_jax(port_run, jax_run):
    (r0, _), _ = port_run
    for field, key, frac in (("mu", "exp_avg", 1e-3), ("nu", "exp_avg_sq", 2e-3)):
        big = max(np.abs(v).max() for v in jax_run[field].values())
        assert sorted(r0["moments"]) == sorted(k for k in jax_run[field] if not k.startswith("encoder.dinov2."))
        for name, m in r0["moments"].items():
            np.testing.assert_allclose(m[key].numpy(), jax_run[field][name], atol=frac * big, rtol=0,
                                       err_msg=f"{field} {name}")


def test_helpers_without_a_process_group():
    assert not dist.active() and dist.rank() == 0 and dist.world_size() == 1
    batch = {"x": np.arange(6)}
    assert dist.shard_batch(batch)["x"].tolist() == list(range(6))
    t = [torch.ones(3)]
    assert dist.all_reduce_mean_(t)[0].tolist() == [1.0, 1.0, 1.0]
    net = torch.nn.BatchNorm2d(3)
    assert dist.replicate(net) is net and len(dist.bn_running_stats(net)) == 2
    assert dist.bn_running_stats(net.eval()) == []
    dist.barrier()
    dist.shutdown()
