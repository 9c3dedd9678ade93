"""One rank of tests/test_torch_distributed.py's data-parallel run, in a
process of its own (spawned): it imports the port only, never JAX."""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.nn as nn

from roma_tpu_torch.models.config import RoMaConfig
from roma_tpu_torch.models.zoo import build_net, init_random
from roma_tpu_torch.parallel import dist
from roma_tpu_torch.train import CheckPoint, RobustLosses, init_train_state, make_optimizer, make_train_step
from roma_tpu_torch.train import train_k_steps


def params_hash(net: nn.Module) -> str:
    h = hashlib.sha256()
    for name, p in net.named_parameters():
        h.update(name.encode())
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def run(rank: int, world: int, port: int, state_dict: dict, batches: list, lrs: dict, ema_decay: float, out: str):
    """Two steps on this rank's slices of the global ``batches``, with the
    EMA; then a save and a restore into a fresh net and optimizer. Writes
    what the test compares to ``out``/rank<r>.pt."""
    torch.set_num_threads(1)
    # torchrun's environment, as the entry points read it
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init("cpu")
    cfg = RoMaConfig.tiny()
    net = build_net(cfg, "cpu")
    net.load_state_dict(state_dict)
    net.train()
    rows = {}  # rows each BatchNorm normalized in the first step, a list by call
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: rows.setdefault(name, []).append(a[0].numel() // a[0].shape[1]))
        for name, m in net.named_modules() if isinstance(m, nn.BatchNorm2d)]
    opt = make_optimizer(net, **lrs)
    state = init_train_state(net, opt)
    step = make_train_step(net, RobustLosses(), opt,
                           forward=lambda n, b: n(b["im_A"], b["im_B"], gm_logit_bias=b["bias"]))
    shards = [{k: torch.from_numpy(v) for k, v in dist.shard_batch(b).items()} for b in batches]
    metrics, stats = [], []
    for shard in shards:
        state, m = train_k_steps(state, [shard], step, ema_decay=ema_decay)
        for h in hooks:
            h.remove()
        hooks = []
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
        stats.append({k: v.clone() for k, v in net.state_dict().items() if "running_" in k})
    moments = {name: {k: v.clone() for k, v in opt.adamw.state[p].items()}
               for name, p in net.named_parameters() if p in opt.adamw.state}
    before = params_hash(net)
    ckpt = CheckPoint(out, "dp")
    ckpt.save(state)
    fresh = init_random(build_net(cfg, "cpu"), seed=7).train()
    fresh_opt = make_optimizer(fresh, **lrs)
    restored = ckpt.load(init_train_state(fresh, fresh_opt))
    after = params_hash(fresh)
    print(f"rank {rank}: params sha256 {before} after 2 steps, {after} restored", flush=True)
    torch.save({
        "params": {k: p.detach().clone() for k, p in net.named_parameters()},
        "stats": stats, "rows": rows, "metrics": metrics, "moments": moments,
        "ema": state.ema_params, "step": state.step, "hash": before, "restored_hash": after,
        "restored_step": restored.step, "restored_count": fresh_opt.count,
        "restored_ema_equal": all(torch.equal(restored.ema_params[k], v) for k, v in state.ema_params.items()),
        "restored_moments_equal": all(
            torch.equal(fresh_opt.adamw.state[p][k], moments[name][k])
            for name, p in fresh.named_parameters() if name in moments for k in moments[name]),
    }, f"{out}/rank{rank}.pt")
    dist.shutdown()


def seeded_batch(b: int, hw: int, seed: int) -> dict:
    """Images of std 0.5 and the smooth identity-pose depth batch of
    tests/test_torch_train.py (the GT warp valid everywhere)."""
    rs = np.random.RandomState(seed)
    ims = [(rs.randn(b, hw, hw, 3) * 0.5).astype(np.float32) for _ in range(2)]
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    depth = 3.0 + 0.5 * np.sin(xx / hw * rs.uniform(2, 4)) * np.cos(yy / hw * rs.uniform(2, 4))
    depth = np.repeat(depth[None], b, 0).astype(np.float32)
    K = np.tile(np.array([[0.8 * hw, 0, hw / 2], [0, 0.8 * hw, hw / 2], [0, 0, 1]], np.float32), (b, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    return {"im_A": ims[0], "im_B": ims[1], "im_A_depth": depth, "im_B_depth": depth.copy(), "T_1to2": T,
            "K1": K, "K2": K.copy()}
