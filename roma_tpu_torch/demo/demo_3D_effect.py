"""A parallax GIF: B sampled along the warp from the identity to A->B and
back (counterpart of demo/demo_3D_effect.py), through the port's
``ops.grid_sample``.

    python -m roma_tpu_torch.demo.demo_3D_effect --im_A_path A.jpg --im_B_path B.jpg [--save_path demo_3d.gif]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from ..ops import grid_sample, normalized_grid
from ..utils.image import load_image, to_array
from .demo_match import add_model_flags, build

FRAMES = 12  # a way


def run(args, model=None):
    model = model or build(args)
    warp, certainty = model.match(args.im_A_path, args.im_B_path)
    h, w2 = warp.shape[:2]
    w = w2 // 2
    dev = warp.device
    x_b = torch.from_numpy(to_array(load_image(args.im_B_path).resize((w, h)))).to(dev)
    grid = normalized_grid(h, w, device=dev)
    a2b = warp[:, :w, 2:].float()
    cert = certainty[:, :w, None].float()
    frames = []
    for alpha in np.concatenate([np.linspace(0, 1, FRAMES), np.linspace(1, 0, FRAMES)]):
        coords = (1 - float(alpha)) * grid + float(alpha) * a2b
        im = grid_sample(x_b[None], coords[None])[0]
        im = cert * im + (1 - cert) * torch.ones_like(im)
        frames.append(Image.fromarray((im.clamp(0, 1) * 255).cpu().numpy().astype(np.uint8)))
    frames[0].save(args.save_path, save_all=True, append_images=frames[1:], duration=80, loop=0)
    print("saved", args.save_path)
    return frames


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_flags(p)
    p.add_argument("--save_path", default="demo_3d.gif")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
