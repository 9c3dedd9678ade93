"""Tiny RoMa's A->B and B->A matches, drawn with their certainty
(counterpart of demo/demo_match_tiny.py).

    python -m roma_tpu_torch.demo.demo_match_tiny --im_A_path A.jpg --im_B_path B.jpg
"""
from __future__ import annotations

import argparse

from ..models import tiny_roma_v1_outdoor


def build(args, config=None):
    """Tiny RoMa from the flags' weights; its architecture is fixed, so
    ``config`` must be None."""
    if config is not None:
        raise ValueError("Tiny RoMa has one architecture; config must be None")
    return tiny_roma_v1_outdoor(weights=args.weights, xfeat_weights=args.xfeat_weights, device=args.device)


def run(args, model=None):
    model = model or build(args)
    out = []
    for a, b, path in ((args.im_A_path, args.im_B_path, args.save_A_path),
                       (args.im_B_path, args.im_A_path, args.save_B_path)):
        warp, cert = model.match(a, b)
        model.visualize_warp(warp, cert, a, b, save_path=path)
        out.append((warp, cert))
    print("saved", args.save_A_path, args.save_B_path)
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--save_A_path", default="demo_tiny_warp_AtoB.jpg")
    p.add_argument("--save_B_path", default="demo_tiny_warp_BtoA.jpg")
    p.add_argument("--weights", default=None)
    p.add_argument("--xfeat_weights", default=None)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
