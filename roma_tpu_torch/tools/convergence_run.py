"""Synthetic convergence run (counterpart of tools/convergence_run.py).

A few hundred steps of the full training recipe on one device: RobustLosses
(the coarse anchor classification at scale 16, Charbonnier regression at the
finer scales, local-distance gating), two-group AdamW with a linear warmup
and a MultiStep decay, a global gradient clip of 0.01, and the
warmup-ramped EMA of the parameters. Faults in the loss wiring (scale
gating, stop-gradients, the classification target) show only over hundreds
of steps.

The pairs are analytic: an infinite textured plane (a smooth random Fourier
texture) fronto-parallel to camera A at depth d ~ U(4, 8), camera B rotated
by up to ~2 degrees an axis and translated. Both images and both depth maps
are rendered from the plane's geometry without resampling, so ``get_gt_warp``
recovers the exact correspondence field and the dense PCK against it means
what it says. ``make_pair``, ``make_batch`` and ``_texture`` are the JAX
tool's NumPy formulas: on one RandomState they give its arrays bit for bit.

Configurations:
  --config tiny: ``RoMaConfig.tiny()`` (head dim 16: attention takes the
    einsum on the card, as in the JAX package);
  --config small: ``RoMaConfig.small()``, whose head dims of 64 take
    Kernels A and E on the card;
  --config full: the released ``RoMaConfig()``, bf16 autocast and remat.

The evaluation runs the net in training mode, so BatchNorm normalizes with
the evaluation batch's own statistics, as the JAX tool's evaluation does;
the running statistics are put back afterwards. It scores the parameters
after training and their EMA.

Writes ``CONVERGENCE_TORCH_<tag>.json`` (the JAX report's keys, the card's
line and the port kernels' launches over the run) and
``CONVERGENCE_TORCH_<tag>.steps.jsonl`` (the logged steps) at the root of
the repository, or in ``main(out_dir=)``.

    python3 -m roma_tpu_torch.tools.convergence_run [--device cpu] [--steps 300] [--res 112] [--batch 8]
    python3 -m roma_tpu_torch.tools.convergence_run --config full --res 560 --batch 4 --steps 200 --tag r01
"""
from __future__ import annotations

import argparse
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..datasets.loader import to_device
from ..models import RoMaConfig
from ..models.zoo import train_net
from ..ops import KERNEL_WRAPPERS
from ..train import RobustLosses, get_gt_warp, make_ema_update, make_optimizer, make_train_step
from ..utils.image import IMAGENET_MEAN, IMAGENET_STD
from . import card_line

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = {"tiny": RoMaConfig.tiny, "small": RoMaConfig.small, "full": RoMaConfig}

# the reference recipe's shape (experiments/train_roma_outdoor.py:214-227),
# its learning rates scaled to the synthetic task, as the JAX tool has them
LOSSES = RobustLosses(ce_weight=0.01, local_dist=((1, 4.0), (2, 4.0), (4, 8.0), (8, 8.0)), local_largest_scale=8,
                      alpha=0.5, c=1e-4)
ENCODER_LR, DECODER_LR, WARMUP_STEPS, GRAD_CLIP, EMA_DECAY = 2e-4, 6e-4, 20, 0.01, 0.995
EVAL_SEED = 999


def optimizer(net, steps: int):
    """The run's optimizer: the learning rates drop by 0.2 at 90% of the steps."""
    return make_optimizer(net, ENCODER_LR, DECODER_LR, (int(0.9 * steps),), grad_clip=GRAD_CLIP,
                          warmup_steps=WARMUP_STEPS)


def _texture(rs: np.random.RandomState, n_comp: int = 10):
    """Smooth random Fourier texture R^2 -> [0,1]^3 (world-plane units)."""
    freq = rs.uniform(0.15, 1.6, (3, n_comp, 2))
    phase = rs.uniform(0, 2 * math.pi, (3, n_comp))
    amp = rs.uniform(0.3, 1.0, (3, n_comp)) / np.sqrt(n_comp)

    def f(x, y):
        # x, y: (H, W) world-plane coords -> (H, W, 3)
        arg = (
            freq[..., 0][:, :, None, None] * x[None, None]
            + freq[..., 1][:, :, None, None] * y[None, None]
            + phase[:, :, None, None]
        )
        v = (amp[:, :, None, None] * np.sin(arg)).sum(1)  # (3, H, W)
        v = 0.5 + 0.5 * v / (np.abs(v).max() + 1e-6)
        return np.transpose(v, (1, 2, 0)).astype(np.float32)

    return f


def _small_rotation(rs, max_deg=2.0):
    a = np.deg2rad(rs.uniform(-max_deg, max_deg, 3))
    cx, sx = np.cos(a[0]), np.sin(a[0])
    cy, sy = np.cos(a[1]), np.sin(a[1])
    cz, sz = np.cos(a[2]), np.sin(a[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float64)


def make_pair(rs: np.random.RandomState, res: int):
    """One posed pair, NumPy arrays. Pixel k has continuous coordinate
    k + 0.5 (the reference's [0.5, w - 0.5] convention, utils.py:402-404)."""
    return _render(res, *_draw(rs))


def _draw(rs: np.random.RandomState):
    """A pair's random draws, in make_pair's order: every draw comes before
    the rendering, so pairs can render in parallel once drawn."""
    d = rs.uniform(4.0, 8.0)
    R = _small_rotation(rs)
    # translation: up to ~12 px image shift + slight depth change
    t = np.array(
        [rs.uniform(-0.1, 0.1) * d, rs.uniform(-0.1, 0.1) * d, rs.uniform(-0.05, 0.05) * d]
    )
    return d, R, t, _texture(rs)


def _render(res: int, d, R, t, tex):
    f = float(res)  # focal
    cx = cy = res / 2.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)

    u = np.arange(res, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, u, indexing="xy")

    # camera A: fronto-parallel plane at z=d (A frame == world frame)
    XA = (uu - cx) / f * d
    YA = (vv - cy) / f * d
    im_A = tex(XA, YA)
    depth_A = np.full((res, res), d, np.float32)

    # camera B: X_B = R X_A + t; plane n=(0,0,1), n.X_A = d
    # ray r = K^-1 (u, v, 1); s = (d + m.t) / (m.r), m = R n
    m = R[:, 2]  # R @ n
    rx = (uu - cx) / f
    ry = (vv - cy) / f
    denom = m[0] * rx + m[1] * ry + m[2]
    s = (d + m @ t) / denom
    XB, YB, ZB = s * rx, s * ry, s
    depth_B = ZB.astype(np.float32)
    # world point = R^T (X_B - t)
    P = np.stack([XB - t[0], YB - t[1], ZB - t[2]], -1) @ R  # (H,W,3) (R^T)^T
    im_B = tex(P[..., 0], P[..., 1])

    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    norm = lambda im: (im - IMAGENET_MEAN) / IMAGENET_STD
    return {
        "im_A": norm(im_A),
        "im_B": norm(im_B),
        "im_A_depth": depth_A,
        "im_B_depth": depth_B,
        "T_1to2": T.astype(np.float32),
        "K1": K.astype(np.float32),
        "K2": K.astype(np.float32),
    }


def make_batch(rs, b, res, pool=None):
    """``b`` pairs stacked; ``pool`` (an executor) renders them in parallel
    after drawing them in turn, which gives the same arrays."""
    draws = [_draw(rs) for _ in range(b)]
    items = list((pool.map if pool is not None else map)(lambda dr: _render(res, *dr), draws))
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def dense_pck(corresps, batch, thresholds=(1.0, 3.0, 5.0)):
    """PCK of the scale-1 flow against the analytic GT warp over its valid
    pixels (prob > 0.99), in B-image pixels, and the mean end-point error.
    ``corresps[1]["flow"]`` is the port's NHWC (B, H, W, 2) flow; ``batch``
    holds arrays or tensors, moved to the flow's device."""
    flow = corresps[1]["flow"].detach().float()
    b, h, w, _ = flow.shape
    t = {k: torch.as_tensor(batch[k], device=flow.device)
         for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")}
    x2, prob = get_gt_warp(t["im_A_depth"], t["im_B_depth"], t["T_1to2"], t["K1"], t["K2"], H=h, W=w)
    scale = torch.tensor([w / 2, h / 2], dtype=torch.float64, device=flow.device)
    err = torch.linalg.vector_norm((flow - x2).double() * scale, dim=-1)[prob > 0.99]
    return {f"pck_{int(th)}": (err < th).double().mean().item() for th in thresholds}, err.mean().item()


@torch.no_grad()
def evaluate(net, batch: dict, amp_dtype=None, params: dict | None = None):
    """:func:`dense_pck` of one forward on ``batch`` in training mode (the
    batch's own BatchNorm statistics), with ``params`` (by name) in place of
    the net's own when given; the net's parameters and buffers are as
    before afterwards."""
    buffers = {k: b.clone() for k, b in net.named_buffers()}
    own = {k: p.detach().clone() for k, p in net.named_parameters()} if params is not None else None
    try:
        if params is not None:
            for k, p in net.named_parameters():
                p.copy_(params[k])
        net.train()
        dev = batch["im_A"].device.type
        with torch.autocast(dev, dtype=amp_dtype or torch.bfloat16, enabled=amp_dtype is not None):
            corresps = net(batch["im_A"], batch["im_B"])
        return dense_pck(corresps, batch)
    finally:
        for k, b in net.named_buffers():
            b.copy_(buffers[k])
        if own is not None:
            for k, p in net.named_parameters():
                p.copy_(own[k])


def bn_stats_finite(net) -> bool:
    stats = [b for k, b in net.named_buffers() if k.endswith(("running_mean", "running_var"))]
    return bool(torch.stack([torch.isfinite(b).all() for b in stats]).all())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=tuple(CONFIGS), default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--res", type=int, default=112)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--seed", type=int, default=0, help="the weights' seed and the training pairs' RandomState")
    return ap


def main(argv=None, out_dir=ROOT) -> dict:
    """The run; its report and step log are written to ``out_dir`` (by
    default the root of the repository)."""
    args = parser().parse_args(argv)
    out_dir = Path(out_dir)
    device = torch.device(args.device)
    full = args.config == "full"
    amp_dtype = torch.bfloat16 if full else None
    net = train_net(CONFIGS[args.config](), device, seed=args.seed, remat=full)
    step = make_train_step(net, LOSSES, optimizer(net, args.steps), amp_dtype=amp_dtype)
    params = dict(net.named_parameters())
    ema = {k: p.detach().float().clone() for k, p in params.items()}
    ema_update = make_ema_update(EMA_DECAY)
    launched = {f.__name__: f.launches for f in KERNEL_WRAPPERS}

    rs = np.random.RandomState(args.seed)
    eval_batch = to_device(make_batch(np.random.RandomState(EVAL_SEED), args.batch, args.res), device)
    steps_file = out_dir / f"CONVERGENCE_TORCH_{args.tag}.steps.jsonl"
    t0 = time.perf_counter()
    pck0, epe0 = evaluate(net, eval_batch, amp_dtype)
    print(f"step 0: eval {pck0} epe_px {epe0:.4f}", flush=True)
    history = []
    nonfinite = torch.zeros((), device=device)
    with ThreadPoolExecutor(1) as ahead, ThreadPoolExecutor(args.batch) as render, open(steps_file, "w") as log:
        # the next batch is drawn and rendered on the host while the device
        # takes a step (a 560^2 batch of 4 takes seconds on one core)
        upcoming = ahead.submit(make_batch, rs, args.batch, args.res, render)
        t_train, waited = time.perf_counter(), 0.0
        for i in range(1, args.steps + 1):
            t_wait = time.perf_counter()
            arrays = upcoming.result()
            waited += time.perf_counter() - t_wait
            batch = to_device(arrays, device)
            if i < args.steps:
                upcoming = ahead.submit(make_batch, rs, args.batch, args.res, render)
            metrics = step(batch)
            ema_update(ema, params, i - 1)
            nonfinite += metrics["nonfinite_grads"] > 0
            if i % args.log_every == 0 or i == 1:
                rec = {
                    "step": i,
                    "loss": metrics["loss"].item(),
                    "gm_cls_loss_16": metrics["gm_cls_loss_16"].item(),
                    "train_pck_05": metrics["train_pck_05"].item(),
                    "grad_norm": metrics["grad_norm"].item(),
                    "nonfinite_grads": metrics["nonfinite_grads"].item(),
                    "bn_stats_finite": bn_stats_finite(net),
                    "wall_s": time.perf_counter() - t0,
                }
                history.append(rec)
                log.write(json.dumps(rec) + "\n")
                log.flush()
                print(rec, flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t_train
    pck1, epe1 = evaluate(net, eval_batch, amp_dtype)
    pck_ema, epe_ema = evaluate(net, eval_batch, amp_dtype, params=ema)
    print(f"final eval {pck1} epe_px {epe1:.4f} | ema {pck_ema} epe_px {epe_ema:.4f}", flush=True)

    first = float(np.mean([h["loss"] for h in history[:3]]))
    last = float(np.mean([h["loss"] for h in history[-3:]]))
    name = {"tiny": "RoMaConfig.tiny()", "small": "RoMaConfig.small()", "full": "RoMaConfig() full dims"}[args.config]
    report = {
        "config": f"{name}, res {args.res}, batch {args.batch}, {args.steps} steps on one {device.type} device, "
                  "full recipe (RobustLosses cls+Charbonnier+gating, two-group AdamW, warmup, MultiStep, clip 0.01, "
                  "warmup-ramped EMA 0.995" + (", bf16+remat" if full else "") + ")",
        "loss_first3_logged": first,
        "loss_last3_logged": last,
        "eval_pck_before": pck0,
        "eval_pck_after": pck1,
        "eval_pck_after_ema": pck_ema,
        "eval_epe_px_before": epe0,
        "eval_epe_px_after": epe1,
        "eval_epe_px_after_ema": epe_ema,
        "grad_norm_last": history[-1]["grad_norm"],
        "bn_stats_finite": all(h["bn_stats_finite"] for h in history),
        # over every step, not only the logged ones
        "nonfinite_grad_steps": int(nonfinite.item()),
        "steps_per_s": args.steps / train_s,
        # the host's wait on the next rendered batch, a step
        "batch_wait_s": waited / args.steps,
        "wall_s": time.perf_counter() - t0,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else None,
        "torch": torch.__version__,
        "launches": {f.__name__: f.launches - launched[f.__name__] for f in KERNEL_WRAPPERS},
        "ok": bool(last < first and pck1["pck_5"] > pck0["pck_5"]),
    }
    with open(out_dir / f"CONVERGENCE_TORCH_{args.tag}.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
