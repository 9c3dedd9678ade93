"""Train big RoMa on MegaDepth (counterpart of
experiments/train_roma_outdoor.py; reference
experiments/train_roma_outdoor.py:169-308).

The recipe: two overlap-band copies of the train_loftr scenes (0.01-1 and
0.35-0.9, shake 32, horizontal flips, random erasing), 1/n^0.75 scene
weights, RobustLosses (cls@16 + robust regression, alpha 0.5, c 1e-4,
local_dist {1: 4, 2: 4, 4: 8, 8: 8}), AdamW with encoder and decoder rates
scaled by the global batch, MultiStepLR decay at 90% of 8M samples, grad
clip 0.01, a checkpoint and the dense benchmark every 25k samples.

    python -m roma_tpu_torch.experiments.train_roma_outdoor --data_root data/megadepth
    torchrun --nproc_per_node 4 -m roma_tpu_torch.experiments.train_roma_outdoor \\
        --data_root data/megadepth --distributed

``--gpu_batch_size`` is one card's batch; under torchrun each rank loads its
slice of the epoch's index stream.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..benchmarks.mega_dense import MegadepthDenseBenchmark
from ..datasets.transforms import RandomErasing
from ..models import RegressionMatcher, RoMaConfig, pretrained_backbone, train_net
from ..parallel import dist
from ..train import CheckPoint, RobustLosses, init_train_state, make_optimizer, make_train_step, train_k_steps
from .common import (
    RESOLUTIONS,
    DeviceBatches,
    Recipe,
    add_common_flags,
    epoch_loader,
    megadepth_bands,
    progress,
    setup,
)

N_SAMPLES = 8_000_000


def build(args, config: RoMaConfig | None = None, data=None) -> Recipe:
    """The recipe's objects, the checkpoint in ``--ckpt_dir`` restored if
    there is one. ``config`` replaces the released architecture (tests);
    ``data`` = (dataset, weights) replaces MegaDepth's two bands with
    another dataset of the same items (e.g. a ScanNet tree)."""
    device = setup(args)
    h, w = RESOLUTIONS[args.train_resolution]
    step_size = args.gpu_batch_size * dist.world_size()  # samples a step (reference STEP_SIZE)
    n_steps = N_SAMPLES // step_size

    net = train_net(config, device, seed=0, remat=args.remat)
    if args.pretrained_backbone:
        # the reference trains from a pretrained backbone (train_roma_outdoor.py:187)
        pretrained_backbone(net, dinov2_weights=args.dinov2_weights, vgg_weights=args.vgg_weights)
    if data is None:
        data = megadepth_bands(args.data_root, h, w, shake_t=32, use_horizontal_flip_aug=True,
                               random_eraser=RandomErasing(p=0.2))
    objective = RobustLosses(
        ce_weight=0.01,
        local_dist=((1, 4.0), (2, 4.0), (4, 8.0), (8, 8.0)),
        local_largest_scale=8,
        alpha=0.5,
        c=1e-4,
    )
    optimizer = make_optimizer(
        net,
        encoder_lr=step_size * 5e-6 / 8,
        decoder_lr=step_size * 1e-4 / 8,
        milestones=(int(0.9 * n_steps),),
        grad_clip=0.01,
        warmup_steps=args.warmup_steps,
    )
    step = make_train_step(net, objective, optimizer, amp_dtype=torch.bfloat16 if args.bf16 else None)
    state = init_train_state(net, optimizer)
    checkpointer = CheckPoint(args.ckpt_dir, "train_roma_outdoor")
    state = checkpointer.load(state)
    return Recipe(state=state, step=step, dataset=data[0], weights=data[1], checkpointer=checkpointer,
                  device=device, hw=(h, w), batch_size=args.gpu_batch_size, n_steps=n_steps)


def train_epoch(r: Recipe, args, host_rng: np.random.RandomState, bench=None) -> dict:
    """One epoch of K_SAMPLES from the loader, a checkpoint, then on rank 0
    the dense benchmark; returns the last step's metrics."""
    loader = epoch_loader(r.dataset, r.weights, r.batch_size, host_rng, args.num_workers)
    r.state, metrics = train_k_steps(
        r.state, DeviceBatches(loader, r.device), r.step,
        ema_decay=args.ema_decay if args.ema_decay > 0 else None,
        warn_nonfinite=args.warn_nonfinite,
        progress=progress(args.log_every),
    )
    r.checkpointer.save(r.state)
    if bench is not None and dist.rank() == 0:
        h, w = r.hw
        model = RegressionMatcher(r.state.net, h=h, w=w, upsample_preds=False, symmetric=False)
        results = bench.benchmark(model, batch_size=args.gpu_batch_size)
        print(json.dumps({"step": r.state.step, **results}), flush=True)
    return metrics


def run(args):
    r = build(args)
    bench = None if args.skip_eval else MegadepthDenseBenchmark(args.data_root, num_samples=256)
    host_rng = np.random.RandomState(0)  # the same stream on every rank; each takes its slice
    while r.state.step < r.n_steps and not args.only_test:
        train_epoch(r, args, host_rng, bench)
    print("training done at step", r.state.step)
    dist.shutdown()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--train_resolution", default="medium", choices=RESOLUTIONS)
    p.add_argument("--only_test", action="store_true")
    p.add_argument("--skip_eval", action="store_true")
    add_common_flags(p)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                   help="recompute VGG, the GP, the TransformerDecoder and the refiners in the backward")
    # the reference always trains from a pretrained backbone
    p.add_argument("--pretrained_backbone", action=argparse.BooleanOptionalAction, default=True,
                   help="load torchvision VGG19-BN + DINOv2 vitl14 encoder weights "
                   "(fetched, or --dinov2_weights/--vgg_weights paths)")
    p.add_argument("--dinov2_weights", default=None, help="local dinov2_vitl14_pretrain.pth")
    p.add_argument("--vgg_weights", default=None, help="local torchvision vgg19_bn .pth")
    p.add_argument("--ema_decay", type=float, default=0.0, help="EMA of params; 0 disables (ref ema_model)")
    p.add_argument("--warmup_steps", type=int, default=0, help="linear LR warmup steps (ref warmup.dampening())")
    p.add_argument("--warn_nonfinite", action="store_true", help="print param names with nan/inf grads each step")
    return p


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
