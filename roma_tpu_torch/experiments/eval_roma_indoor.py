"""Evaluate big RoMa indoor on ScanNet-1500 (counterpart of
experiments/eval_roma_indoor.py).

    python -m roma_tpu_torch.experiments.eval_roma_indoor --weights roma_indoor.pth \\
        --dinov2_weights dinov2_vitl14_pretrain.pth --data_root data/scannet
"""
from __future__ import annotations

import argparse

from ..benchmarks import ScanNetBenchmark
from ..models import RoMaConfig, roma_indoor
from .eval_common import add_eval_flags, write_results


def build(args, config: RoMaConfig | None = None):
    """The matcher the flags ask for; ``config`` replaces the released
    architecture (tests)."""
    return roma_indoor(weights=args.weights, dinov2_weights=args.dinov2_weights, coarse_res=args.coarse_res,
                       upsample_res=args.upsample_res, amp=args.bf16, device=args.device, config=config)


def run(args, model=None) -> dict:
    model = model or build(args)
    return write_results({"scannet": ScanNetBenchmark(args.data_root).benchmark(model)}, args.out)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None)
    p.add_argument("--dinov2_weights", default=None)
    p.add_argument("--data_root", default="data/scannet")
    p.add_argument("--coarse_res", type=int, default=560)
    p.add_argument("--upsample_res", type=int, default=864)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    add_eval_flags(p, "results/eval_roma_indoor_torch.json")
    return p


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
