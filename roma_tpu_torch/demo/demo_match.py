"""Warp and certainty of a pair, drawn (counterpart of demo/demo_match.py).

    python -m roma_tpu_torch.demo.demo_match --im_A_path A.jpg --im_B_path B.jpg [--save_path warp.jpg]
"""
from __future__ import annotations

import argparse

from ..models import RoMaConfig, roma_outdoor


def add_model_flags(p: argparse.ArgumentParser):
    """The pair (required) and the weights and device of big RoMa."""
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--dinov2_weights", default=None)
    p.add_argument("--coarse_res", type=int, default=560)
    p.add_argument("--upsample_res", type=int, default=864)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def build(args, config: RoMaConfig | None = None):
    """roma_outdoor from the flags; ``config`` replaces the released
    architecture (tests)."""
    return roma_outdoor(weights=args.weights, dinov2_weights=args.dinov2_weights, coarse_res=args.coarse_res,
                        upsample_res=args.upsample_res, device=args.device, config=config)


def run(args, model=None):
    model = model or build(args)
    warp, certainty = model.match(args.im_A_path, args.im_B_path)
    model.visualize_warp(warp, certainty, args.im_A_path, args.im_B_path, save_path=args.save_path)
    print("saved", args.save_path)
    return warp, certainty


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_flags(p)
    p.add_argument("--save_path", default="demo_warp.jpg")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
