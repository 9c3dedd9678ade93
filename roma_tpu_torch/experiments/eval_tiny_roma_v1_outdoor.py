"""Evaluate Tiny RoMa v1 on Mega-1500, and Mega-8-scenes if asked
(counterpart of experiments/eval_tiny_roma_v1_outdoor.py; reference
experiments/eval_tiny_roma_v1_outdoor.py:73-83).

    python -m roma_tpu_torch.experiments.eval_tiny_roma_v1_outdoor --weights tiny_roma_v1_outdoor.pth \\
        --xfeat_weights xfeat.pt --data_root data/megadepth
"""
from __future__ import annotations

import argparse

from ..benchmarks import MEGA_8_SCENES, MegaDepthPoseEstimationBenchmark
from ..models import tiny_roma_v1_outdoor
from .eval_common import add_eval_flags, write_results


def build(args, config=None):
    """Tiny RoMa from the flags' weights; its architecture is fixed, so
    ``config`` must be None (the big-RoMa entry points' signature)."""
    if config is not None:
        raise ValueError("Tiny RoMa has one architecture; config must be None")
    return tiny_roma_v1_outdoor(weights=args.weights, xfeat_weights=args.xfeat_weights, device=args.device)


def run(args, model=None) -> dict:
    model = model or build(args)
    name = "tiny_roma_v1_outdoor"
    results = {"mega1500": MegaDepthPoseEstimationBenchmark(args.data_root).benchmark(model, model_name=name)}
    if args.mega_8_scenes:
        bench8 = MegaDepthPoseEstimationBenchmark(args.data_root, scene_names=MEGA_8_SCENES)
        results["mega_8_scenes"] = bench8.benchmark(model, model_name=name)
    return write_results(results, args.out)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None)
    p.add_argument("--xfeat_weights", default=None)
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--mega_8_scenes", action="store_true")
    add_eval_flags(p, "results/eval_tiny_roma_v1_outdoor_torch.json")
    return p


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
