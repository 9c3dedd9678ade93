"""Train big RoMa indoor: MegaDepth and ScanNet batches in turn
(counterpart of experiments/train_roma_indoor.py; reference
experiments/roma_indoor.py:169-322).

Two loss instances (ScanNet's with ce_weight 0, reference :214-229), one
step a batch alternating between the two streams (:272-278); otherwise the
outdoor recipe.

    python -m roma_tpu_torch.experiments.train_roma_indoor --mega_root data/megadepth --scannet_root data/scannet
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..datasets.megadepth import ConcatDataset, MegadepthBuilder
from ..datasets.scannet import ScanNetBuilder
from ..models import RoMaConfig, pretrained_backbone, train_net
from ..parallel import dist
from ..train import CheckPoint, RobustLosses, init_train_state, make_optimizer, make_train_step
from .common import RESOLUTIONS, DeviceBatches, Recipe, add_common_flags, epoch_loader, setup

N_SAMPLES = 8_000_000
STREAMS = ("mega", "scannet")


def build(args, config: RoMaConfig | None = None) -> Recipe:
    """The recipe's objects; ``step``, ``dataset`` and ``weights`` are dicts
    keyed by stream ("mega", "scannet"). ``config`` replaces the released
    architecture (tests)."""
    device = setup(args)
    h, w = RESOLUTIONS[args.train_resolution]
    batch_size = args.gpu_batch_size * dist.world_size()
    n_steps = N_SAMPLES // batch_size

    net = train_net(config, device, seed=0, remat=args.remat)
    if args.pretrained_backbone:
        # the reference trains from a pretrained backbone (roma_indoor.py:246)
        pretrained_backbone(net, dinov2_weights=args.dinov2_weights, vgg_weights=args.vgg_weights)
    mega = MegadepthBuilder(data_root=args.mega_root)
    mega_ds = ConcatDataset(
        mega.build_scenes(split="train_loftr", min_overlap=0.01, ht=h, wt=w, shake_t=32, rank=dist.rank())
    )
    scan_ds = ScanNetBuilder(data_root=args.scannet_root).build_concat(split="train", ht=h, wt=w)
    data = {
        "mega": (mega_ds, MegadepthBuilder.weight_scenes(mega_ds, alpha=0.75)),
        "scannet": (scan_ds, ScanNetBuilder.weight_scenes(scan_ds, alpha=0.75)),
    }
    losses = {"mega": RobustLosses(ce_weight=0.01, alpha=0.5, c=1e-4),
              "scannet": RobustLosses(ce_weight=0.0, alpha=0.5, c=1e-4)}
    optimizer = make_optimizer(
        net,
        encoder_lr=batch_size * 5e-6 / 8,
        decoder_lr=batch_size * 1e-4 / 8,
        milestones=(int(0.9 * n_steps),),
        grad_clip=0.01,
    )
    amp = torch.bfloat16 if args.bf16 else None
    steps = {name: make_train_step(net, losses[name], optimizer, amp_dtype=amp) for name in STREAMS}
    state = init_train_state(net, optimizer)
    checkpointer = CheckPoint(args.ckpt_dir, "train_roma_indoor")
    state = checkpointer.load(state)
    return Recipe(state=state, step=steps, dataset={k: v[0] for k, v in data.items()},
                  weights={k: v[1] for k, v in data.items()}, checkpointer=checkpointer,
                  device=device, hw=(h, w), batch_size=args.gpu_batch_size, n_steps=n_steps)


def train_epoch(r: Recipe, args, host_rng: np.random.RandomState) -> dict:
    """Alternate the two streams, MegaDepth on even steps, until either
    runs out; then a checkpoint. Returns the last step's metrics."""
    batches = {}
    for name in STREAMS:
        loader = epoch_loader(r.dataset[name], r.weights[name], r.batch_size, host_rng, args.num_workers)
        batches[name] = iter(DeviceBatches(loader, r.device))
    metrics: dict = {}
    try:
        while True:
            name = "mega" if r.state.step % 2 == 0 else "scannet"
            batch = next(batches[name], None)
            if batch is None:
                break
            metrics = r.step[name](batch)
            r.state.step += 1
            if r.state.step % args.log_every == 0 and dist.rank() == 0:
                print(f"step {r.state.step}: loss={float(metrics['loss']):.4f}", flush=True)
    finally:
        for it in batches.values():
            it.close()
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
    p.add_argument("--mega_root", default="data/megadepth")
    p.add_argument("--scannet_root", default="data/scannet")
    p.add_argument("--train_resolution", default="medium", choices=RESOLUTIONS)
    add_common_flags(p)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--pretrained_backbone", action=argparse.BooleanOptionalAction, default=True,
                   help="load torchvision VGG19-BN + DINOv2 vitl14 encoder weights "
                   "(reference pretrained_backbone=True)")
    p.add_argument("--dinov2_weights", default=None)
    p.add_argument("--vgg_weights", default=None)
    return p


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
