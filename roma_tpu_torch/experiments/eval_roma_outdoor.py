"""Evaluate big RoMa outdoor on Mega-1500, and Mega-8-scenes if asked, at
coarse 672 / upsample 1344 (counterpart of experiments/eval_roma_outdoor.py;
reference experiments/eval_roma_outdoor.py:50-56).

    python -m roma_tpu_torch.experiments.eval_roma_outdoor --weights roma_outdoor.pth \\
        --dinov2_weights dinov2_vitl14_pretrain.pth --data_root data/megadepth [--vit_int8 --refiner_int8]

``--vit_int8 --refiner_int8`` is the A/B of the int8 serving paths against
the golden metrics; ``--vit_gelu_tanh`` the tanh GELU's. ``--device cpu``
runs off the card.
"""
from __future__ import annotations

import argparse

from ..benchmarks import MEGA_8_SCENES, MegaDepthPoseEstimationBenchmark
from ..models import RoMaConfig, roma_outdoor
from .eval_common import add_eval_flags, write_results


def build(args, config: RoMaConfig | None = None):
    """The matcher the flags ask for; ``config`` replaces the released
    architecture (tests)."""
    return roma_outdoor(weights=args.weights, dinov2_weights=args.dinov2_weights, coarse_res=args.coarse_res,
                        upsample_res=args.upsample_res, amp=args.bf16, vit_int8=args.vit_int8,
                        refiner_int8=args.refiner_int8, vit_gelu_tanh=args.vit_gelu_tanh, device=args.device,
                        config=config)


def run(args, model=None) -> dict:
    model = model or build(args)
    results = {"mega1500": MegaDepthPoseEstimationBenchmark(args.data_root).benchmark(model, model_name="roma_outdoor")}
    if args.mega_8_scenes:
        bench8 = MegaDepthPoseEstimationBenchmark(args.data_root, scene_names=MEGA_8_SCENES)
        results["mega_8_scenes"] = bench8.benchmark(model, model_name="roma_outdoor")
    return write_results(results, args.out)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None)
    p.add_argument("--dinov2_weights", default=None)
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--coarse_res", type=int, default=672)
    p.add_argument("--upsample_res", type=int, default=1344)
    p.add_argument("--mega_8_scenes", action="store_true")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    # serving knobs: A/B the int8 paths against the golden metrics
    p.add_argument("--vit_int8", action="store_true")
    p.add_argument("--refiner_int8", action="store_true")
    p.add_argument("--vit_gelu_tanh", action="store_true")
    add_eval_flags(p, "results/eval_roma_outdoor_torch.json")
    return p


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
