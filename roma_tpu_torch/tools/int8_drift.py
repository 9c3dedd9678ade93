"""Drift of the int8 serving paths from their float twins on the same
weights (counterpart of tools/int8_drift.py): DINOv2's patch tokens with
``int8`` on and off (ViT-L, 24 blocks, d = 1024, 1601 tokens at 560^2), and
one refiner block with a QConv1x1 against the same block's float 1x1 conv
(C = 1137 at 108^2, the upsample pass's scale-8 stack), float32, seeded
random weights (zoo.init_random) and inputs.

    python3 -m roma_tpu_torch.tools.int8_drift [--device cuda]

For each: corr, max|d|/rms and rms(d)/rms, d the difference and rms the
float output's. Random weights measure the quantization's own error, not
the released model's accuracy: the golden-metric A/B
(experiments/eval_roma_outdoor.py --vit_int8 --refiner_int8) is the gate
for that. The flags cut the sizes (the tests run it at a tiny size on the
CPU).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.blocks import nhwc, refiner_block
from ..models.vit import DinoV2
from ..models.zoo import init_random


def drift(ref: torch.Tensor, got: torch.Tensor) -> dict:
    a = ref.double().flatten().cpu().numpy()
    b = got.double().flatten().cpu().numpy()
    rms = float(np.sqrt(np.mean(a**2)))
    return {"corr": float(np.corrcoef(a, b)[0, 1]),
            "max_d_over_rms": float(np.max(np.abs(a - b)) / rms),
            "rms_d_over_rms": float(np.sqrt(np.mean((a - b) ** 2)) / rms)}


def line(name: str, r: dict) -> str:
    return (f"  {name}: corr {r['corr']:.6f}  max|d|/rms {r['max_d_over_rms']:.4f}  "
            f"rms(d)/rms {r['rms_d_over_rms']:.4f}")


def set_int8(module: torch.nn.Module, on: bool):
    for m in module.modules():
        if hasattr(m, "int8"):
            m.int8 = on


@torch.no_grad()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--res", type=int, default=560, help="DINOv2 input side (a multiple of 14)")
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--refiner_c", type=int, default=1137)
    p.add_argument("--refiner_hw", type=int, default=108)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    rs = np.random.RandomState(0)
    report = {}

    n = (args.res // 14) ** 2 + 1
    print(f"DINOv2 {args.res}^2 (N={n}, d={args.dim}, {args.depth} blocks), int8 vs float32:")
    with torch.device("meta"):
        vit = DinoV2(embed_dim=args.dim, depth=args.depth, num_heads=args.heads, int8=True)
    vit = init_random(vit.to_empty(device=dev), 0).eval()
    x = torch.from_numpy(rs.randn(1, args.res, args.res, 3).astype(np.float32)).to(dev)
    set_int8(vit, False)
    ref = vit(x)
    set_int8(vit, True)
    report["dinov2_tokens"] = drift(ref, vit(x))
    side = args.res // 14
    print(line(f"patch tokens ({side}x{side}x{args.dim})", report["dinov2_tokens"]), flush=True)
    del vit

    c, hw = args.refiner_c, args.refiner_hw
    print(f"refiner block C={c} at {hw}^2, int8 vs float32:")
    with torch.device("meta"):
        blk = refiner_block(c, c, 5, int8=True)
    blk = init_random(blk.to_empty(device=dev), 1).eval()
    float_blk = refiner_block(c, c, 5).to(dev).eval()
    float_blk.load_state_dict(blk.state_dict())
    h = torch.from_numpy(rs.randn(1, hw, hw, c).astype(np.float32)).to(dev)
    report["refiner_block"] = drift(nhwc(float_blk, h), nhwc(blk, h))
    print(line("block output", report["refiner_block"]), flush=True)
    return report


if __name__ == "__main__":
    main()
