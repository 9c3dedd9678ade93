"""The wide-C refiner stacks on the card: lane_refiner_stack (Kernel I) and
hcw_refiner_stack (Kernel J) against the model's cuDNN block stack at the
released refiner shapes (counterpart of tools/bench_hcw_refiner.py).

    python3 -m roma_tpu_torch.tools.bench_hcw_refiner [--batch 16]

For each (tag, H, C) of SHAPES: 9 refiner_block modules (block1 and 8 hidden
blocks, C -> C) on seeded random weights and BatchNorm statistics, in eval
mode and bfloat16, run as the match runs them (models/matcher.py:156-158:
cuDNN through ``nhwc``), and the same modules folded with fold_refiner for
the two kernel stacks, so all three compute one stack. Each is timed with
CUDA events (median of 10 calls); one line a shape, then the card line.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..graveyard.pallas_hcw_refiner import hcw_refiner_stack
from ..graveyard.pallas_refiner_lanemajor import lane_refiner_stack
from ..models.blocks import nhwc, refiner_block
from ..ops.refiner_stack import fold_refiner
from . import card_line, fmt_ms, require_card, timed

B = 16
SHAPES = (  # (scale tag, H = W, C): the 560 -> 864 match's wide-C stacks
    ("s8-up", 108, 1137),
    ("s4-up", 216, 569),
    ("s2-up", 432, 144),
    ("s16", 35, 1377),
    ("s8-c", 70, 1137),
    ("s4-c", 140, 569),
    ("s2-c", 280, 144),
)
N_BLOCKS = 9
REPS = 10


@torch.no_grad()
def make_modules(c: int, gen: torch.Generator, device, n: int = N_BLOCKS, dtype=torch.bfloat16):
    """n eval-mode refiner_block(c, c) modules on seeded random weights and
    running statistics (the spread of tools/bench_hcw_refiner.py's folded
    blocks), in ``dtype``, without gradients (the kernels are forward-only)."""
    f = lambda *s, scale=1.0, shift=0.0: shift + scale * torch.randn(*s, generator=gen, device=device)
    mods = []
    for _ in range(n):
        m = refiner_block(c, c).to(device).eval()
        conv1, bn, _, conv2 = m
        conv1.weight.copy_(f(c, 1, 5, 5, scale=0.2))
        conv1.bias.copy_(f(c, scale=0.1))
        bn.weight.copy_(f(c, scale=0.1, shift=1.0))
        bn.bias.copy_(f(c, scale=0.1))
        bn.running_mean.copy_(f(c, scale=0.05))
        bn.running_var.copy_(f(c, scale=0.2, shift=1.0).abs())
        conv2.weight.copy_(f(c, c, 1, 1, scale=1.5 / c**0.5))
        conv2.bias.copy_(f(c, scale=0.1))
        mods.append(m.to(dtype).requires_grad_(False))
    return mods


def model_stack(x: torch.Tensor, mods) -> torch.Tensor:
    """The eval-mode block stack as ConvRefiner runs it at wide C."""
    for m in mods:
        x = nhwc(m, x)
    return x


@torch.no_grad()
def run_shape(tag: str, h: int, c: int, batch: int, device="cuda") -> dict:
    """Time the three stacks at one shape and print its line; returns the
    outputs, the times (None on the CPU) and the largest differences."""
    require_card(device)
    gen = torch.Generator(device=device).manual_seed(0)
    mods = make_modules(c, gen, device)
    blocks = fold_refiner(mods[0], mods[1:])
    x = torch.randn(batch, h, h, c, generator=gen, device=device).to(torch.bfloat16)
    outs, ms = {}, {}
    for name, fn in (("model", lambda: model_stack(x, mods)), ("lane", lambda: lane_refiner_stack(x, blocks)),
                     ("hcw", lambda: hcw_refiner_stack(x, blocks))):
        outs[name], ms[name] = timed(fn, device, REPS)
    ref = outs["model"].float()
    diff = {k: (outs[k].float() - ref).abs().max().item() for k in ("lane", "hcw")}
    ratio = lambda k: "" if ms[k] is None else f" ({ms['model'] / ms[k]:4.2f}x)"
    print(f"{tag:6s} {h}^2 C={c} B={batch}: cuDNN stack {fmt_ms(ms['model'])}  lane {fmt_ms(ms['lane'])}"
          f"{ratio('lane')}  hcw {fmt_ms(ms['hcw'])}{ratio('hcw')}  max|kernel - cuDNN| lane {diff['lane']:.3g} "
          f"hcw {diff['hcw']:.3g} (max|cuDNN| {ref.abs().max().item():.3g})", flush=True)
    return {"outs": outs, "ms": ms, "diff": diff}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=B, help=f"images a call (default {B})")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error(f"--batch must be >= 1, got {args.batch}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    require_card("cuda")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}, bf16, {N_BLOCKS} blocks", flush=True)
    for tag, h, c in SHAPES:
        run_shape(tag, h, c, args.batch)
        torch.cuda.empty_cache()
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
