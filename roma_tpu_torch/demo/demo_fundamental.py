"""A fundamental matrix from a pair (counterpart of demo/demo_fundamental.py):
match, sample, pixel coordinates, then OpenCV's MAGSAC. OpenCV is imported
by ``run``, as the JAX demo imports it.

    python -m roma_tpu_torch.demo.demo_fundamental --im_A_path A.jpg --im_B_path B.jpg
"""
from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from .demo_match import add_model_flags, build


def run(args, model=None):
    import cv2

    model = model or build(args)
    w_A, h_A = Image.open(args.im_A_path).size
    w_B, h_B = Image.open(args.im_B_path).size
    warp, certainty = model.match(args.im_A_path, args.im_B_path)
    matches, certainty = model.sample(warp, certainty)
    kpts1, kpts2 = model.to_pixel_coordinates(matches, h_A, w_A, h_B, w_B)
    F, mask = cv2.findFundamentalMat(
        kpts1.cpu().numpy().astype(np.float64), kpts2.cpu().numpy().astype(np.float64),
        ransacReprojThreshold=0.2, method=cv2.USAC_MAGSAC, confidence=0.999999, maxIters=10000,
    )
    print("F =\n", F)
    print("inliers:", 0 if mask is None else int(mask.sum()), "/", len(kpts1))
    return F, mask


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_flags(p)
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
