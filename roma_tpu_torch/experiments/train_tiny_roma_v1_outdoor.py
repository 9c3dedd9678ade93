"""Train Tiny RoMa v1 on MegaDepth (counterpart of
experiments/train_tiny_roma_v1_outdoor.py; reference
experiments/train_tiny_roma_v1_outdoor.py:325-497).

The recipe: 2M pairs at (768, 1024), images not normalized (reference
:357), XFeat pretrained and frozen, TinyRobustLosses (correlation-volume
InfoNCE + gated regression), AdamW, grad clip 0.01.

    python -m roma_tpu_torch.experiments.train_tiny_roma_v1_outdoor --data_root data/megadepth
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import TinyRoMaNet
from ..models.zoo import WEIGHT_URLS, _fetch_state_dict, _state_dict, convert, init_random
from ..parallel import dist
from ..train import CheckPoint, TinyRobustLosses, init_train_state, make_optimizer, make_train_step, train_k_steps
from .common import DeviceBatches, Recipe, add_common_flags, epoch_loader, megadepth_bands, progress, setup

N_SAMPLES = 2_000_000


def tiny_train_net(device, xfeat_weights=None, seed: int = 0) -> TinyRoMaNet:
    """TinyRoMaNet in training mode on seeded random weights, XFeat frozen and
    loaded from ``xfeat_weights`` (a path or a state dict; fetched when
    None, as the reference hub-loads it, model_zoo/__init__.py:23-27)."""
    with torch.device("meta"):
        net = TinyRoMaNet(train_mode=True, freeze_xfeat=True)
    net = init_random(net.to_empty(device=device), seed)
    sd = _fetch_state_dict(WEIGHT_URLS["xfeat"]) if xfeat_weights is None else _state_dict(xfeat_weights)
    if sd is None:
        print("train_tiny: XFeat weights unavailable; the frozen backbone stays randomly initialized "
              "(will not reproduce the reference recipe)", flush=True)
    else:
        xfeat = {convert.XFEAT_PREFIX + k: v for k, v in sd.items() if not k.startswith(convert.XFEAT_HEADS)}
        convert.load_state(net, xfeat, prefixes=(convert.XFEAT_PREFIX,))
    return net.train()


def build(args, config=None) -> Recipe:
    """The recipe's objects. Tiny RoMa has one architecture, so ``config``
    must be None; ``--h``/``--w`` size a test's run."""
    if config is not None:
        raise ValueError("train_tiny_roma_v1_outdoor: Tiny RoMa has no config to replace")
    device = setup(args)
    h, w = args.h, args.w
    batch_size = args.gpu_batch_size * dist.world_size()
    n_steps = N_SAMPLES // batch_size

    net = tiny_train_net(device, args.xfeat_weights)
    dataset, weights = megadepth_bands(args.data_root, h, w, normalize=False, shake_t=32)
    objective = TinyRobustLosses(
        ce_weight=0.01, alpha=0.5, c=1e-4, epe_mask_prob_th=0.001,
        cert_only_on_consistent_depth=False,
    )
    # XFeat (the encoder group, train.in_encoder) gets no gradient: frozen
    optimizer = make_optimizer(
        net,
        encoder_lr=batch_size * 5e-6 / 8,
        decoder_lr=batch_size * 1e-4 / 8,
        milestones=(int(0.8 * n_steps), int(0.9 * n_steps)),
        grad_clip=0.01,
    )
    step = make_train_step(net, objective, optimizer, amp_dtype=torch.bfloat16 if args.bf16 else None)
    state = init_train_state(net, optimizer)
    checkpointer = CheckPoint(args.ckpt_dir, "train_tiny_roma_v1_outdoor")
    state = checkpointer.load(state)
    return Recipe(state=state, step=step, dataset=dataset, weights=weights, checkpointer=checkpointer,
                  device=device, hw=(h, w), batch_size=args.gpu_batch_size, n_steps=n_steps)


def train_epoch(r: Recipe, args, host_rng: np.random.RandomState) -> dict:
    loader = epoch_loader(r.dataset, r.weights, r.batch_size, host_rng, args.num_workers)
    r.state, metrics = train_k_steps(r.state, DeviceBatches(loader, r.device), r.step,
                                     progress=progress(args.log_every, extra=()))
    r.checkpointer.save(r.state)
    return metrics


def run(args):
    r = build(args)
    host_rng = np.random.RandomState(0)  # the same stream on every rank; each takes its slice
    while r.state.step < r.n_steps:
        train_epoch(r, args, host_rng)
    print("done at", r.state.step)
    dist.shutdown()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--xfeat_weights", default=None)
    p.add_argument("--h", type=int, default=768)
    p.add_argument("--w", type=int, default=1024)
    add_common_flags(p)
    return p


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
