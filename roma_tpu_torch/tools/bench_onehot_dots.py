"""Microbenchmark of the windowed sampler's two building blocks on the card
(counterpart of tools/bench_onehot_dots.py).

    python3 -m roma_tpu_torch.tools.bench_onehot_dots

Q1 (E1): on the TPU, is one f32 weighted one-hot dot faster than two exact
bf16 0/1 dots with an f32 combine? Here both forms are Kernel K
(ops.onehot_dot_f32 / ops.onehot_dot_2bf16): the two row picks are lookups
in the tile's column 0, staged once in shared memory, no contraction. Q2
(E2): a per-tile window sum, Kernel L (ops.window_sum, which sums each table
row once and then each tile's row sums), against materialising the same
rows with one ``index_select`` (the JAX tool's ``jnp.take``). Sizes are the JAX tool's;
inputs come from a seeded torch.Generator; times are CUDA-event medians.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops.onehot_dots import onehot_dot_2bf16, onehot_dot_f32, window_rows, window_sum
from . import card_line, fmt_ms, require_card, timed

# --- E1: one-hot row picks ---------------------------------------------------
# Tile shapes ~ the v1 sampler: win (WH, C * WW), queries NQ * QS a tile.
WH, CWW, QS, NQ = 128, 1728, 1024, 4
NT = 3136  # 864^2 / 64^2 tiles * 16 images
# --- E2: window fetch -------------------------------------------------------
# table (B2, HP, NJ, XQC); a tile's window is (WH, NS, XQC) at (img, oy, jx).
B2, HP, NJ, XQC = 16, 928, 8, 1152
NS = 3
NT2 = 189 * 16
REPS = 20


def e1_inputs(gen: torch.Generator, nt: int = NT, cww: int = CWW, device="cuda"):
    """win (nt, WH, cww) bf16, yl int32 in [0, WH - 2] and fy float32 in
    [0, 1), both (nt, 1, NQ * QS): the JAX tool's e1 inputs."""
    t = NQ * QS
    win = torch.randn(nt, WH, cww, generator=gen, device=device).to(torch.bfloat16)
    yl = torch.randint(0, WH - 1, (nt, 1, t), generator=gen, device=device, dtype=torch.int32)
    fy = torch.rand(nt, 1, t, generator=gen, device=device)
    return win, yl, fy


def e2_inputs(gen: torch.Generator, nt: int = NT2, b: int = B2, hp: int = HP, device="cuda"):
    """tab (b, hp, NJ, XQC) bf16 and each tile's oy, jx, img (nt,) int32:
    the JAX tool's e2 inputs."""
    tab = torch.randn(b, hp, NJ, XQC, generator=gen, device=device).to(torch.bfloat16)
    ri = lambda hi: torch.randint(0, hi, (nt,), generator=gen, device=device, dtype=torch.int32)
    return tab, ri(hp - WH), ri(NJ - NS), ri(b)


@torch.no_grad()
def e1(nt: int = NT, cww: int = CWW, device="cuda") -> dict:
    """Both Kernel K entries on the tool's inputs; prints their times and
    the rate of the bytes they need (yl, fy and out, 12 bytes a query)."""
    require_card(device)
    win, yl, fy = e1_inputs(torch.Generator(device=device).manual_seed(0), nt, cww, device)
    nbytes = 12 * yl.numel()
    res = {}
    for name, fn, label in (("f32", onehot_dot_f32, "f32 weighted picks"), ("2bf16", onehot_dot_2bf16,
                                                                           "2 exact bf16 picks")):
        out, ms = timed(lambda fn=fn: fn(win, yl, fy), device, REPS)
        rate = "" if ms is None else f"  ({nbytes / ms / 1e6:7.1f} GB/s of yl, fy, out)"
        print(f"E1 {label:22s}: {fmt_ms(ms)}{rate}", flush=True)
        res[name] = (out, ms)
    return res


@torch.no_grad()
def e2(nt: int = NT2, b: int = B2, hp: int = HP, device="cuda") -> dict:
    """Kernel L on the tool's inputs, then the same window rows gathered by
    one index_select; prints both times and their rates in window bytes
    (every window's rows, as the TPU tool counts them) and, for L, in
    covered table bytes (each table row some window covers, once: what L
    reads, since the windows overlap)."""
    require_card(device)
    tab, oy, jx, img = e2_inputs(torch.Generator(device=device).manual_seed(1), nt, b, hp, device)
    tabf = tab.view(-1, XQC)
    rows = window_rows(tab, oy, jx, img, WH, NS).reshape(-1)
    nbytes = nt * WH * NS * XQC * 2
    covered = 2 * XQC * int(torch.zeros(tabf.shape[0], dtype=torch.bool, device=device).index_fill_(0, rows, True).sum())
    gbs = lambda n, ms: f"{n / ms / 1e6:7.1f} GB/s"
    sums, ms = timed(lambda: window_sum(tab, oy, jx, img, WH, NS), device, REPS)
    rate = "" if ms is None else f"  ({gbs(nbytes, ms)} of window bytes, {gbs(covered, ms)} of covered table bytes)"
    print(f"E2 window fetch + sum  : {fmt_ms(ms)}{rate}", flush=True)
    _, gms = timed(lambda: tabf.index_select(0, rows), device, REPS)
    rate = "" if gms is None else f"  ({gbs(nbytes, gms)} of window bytes)"
    print(f"E2 index_select rows   : {fmt_ms(gms)}{rate}", flush=True)
    return {"sums": (sums, ms), "gather_ms": gms, "inputs": (tab, oy, jx, img), "covered_bytes": covered}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    require_card("cuda")
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    e1()
    torch.cuda.empty_cache()
    e2()
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
