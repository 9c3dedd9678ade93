"""Variants of Kernels B and D timed against the sources as they stand.

    python3 -m roma_tpu_torch.tools.kernel_variants [--only NAME ...]

Each variant is a copy of ``csrc/local_corr.cu`` or ``csrc/refiner_stack.cu``
with named text replaced (VARIANTS), built alone by nvcc into
``build/kernel_variants/<name>.so`` (all builds in parallel) and called
through its C entry on bf16 inputs at the main path's shapes (B's five
local-correlation scales, D's 9-block scale-1 stacks at 560^2 and 864^2,
B = 2). For each it prints the device time of each shape (calls captured in
a CUDA graph and replayed, the median over replays), their sum, and the
largest difference from the plain version; then the card line. The
variants are the choices the redesign of B and D weighed; "b" and "d" are
the sources unchanged. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _ext, ops
from ..ops.local_corr import corr_checks
from . import card_line, cuda_ms, require_card

OUT = _ext.BUILD_DIR.parent / "kernel_variants"
# name -> (source, [(text, replacement), ...])
VARIANTS = {
    "b": ("local_corr.cu", []),
    "b_round32": ("local_corr.cu", [("ROUND = 16;", "ROUND = 32;")]),
    "b_warps8": ("local_corr.cu", [("WARPS = 4;", "WARPS = 8;")]),
    "b_loads8": ("local_corr.cu", [("G = NV <= 2 ? 4 : 2;", "G = NV <= 2 ? 8 : 4;")]),
    "b_p_at_run_time": ("local_corr.cu", [("switch (2 * R + 2) {", "switch (0) {")]),
    "b_p_constant_c512": ("local_corr.cu", [("nv == 2 ? launch_vec<scalar_t, 2, 0>(",
                                             "nv == 2 ? launch_const_p<scalar_t, 2>(")]),
    "d": ("refiner_stack.cu", []),
    "d_one_block_an_sm": ("refiner_stack.cu", [("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")]),
}
CORR_SHAPES = (("coarse s16 40^2 C512 r7", 40, 512, 7), ("coarse s8 70^2 C512 r3", 70, 512, 3),
               ("coarse s4 140^2 C256 r2", 140, 256, 2), ("upsample s8 108^2 C512 r3", 108, 512, 3),
               ("upsample s4 216^2 C256 r2", 216, 256, 2))
P, I = ctypes.c_void_p, ctypes.c_int


def variant_source(source: str, reps) -> str:
    """The source with each replacement made; raises if a text is missing."""
    text = (_ext._CSRC / source).read_text()
    for old, new in reps:
        if old not in text:
            raise ValueError(f"{source}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build(name: str) -> Path:
    source, reps = VARIANTS[name]
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(variant_source(source, reps))
    res = subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-I", str(_ext._CSRC), "-shared", str(cu), "-o",
                          str(so)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    return so


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ~2 ms of calls captured in one CUDA graph,
    replayed between events, the median over replays."""
    inner = max(1, min(20, round(2.0 / max(cuda_ms(fn, 5), 1e-3))))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def smooth_warp(gen, b, h, w):
    """The identity warp plus smooth noise of amplitude 0.1."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device="cuda")
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device="cuda")
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    noise = torch.randn(b, 2, max(h // 8, 2), max(w // 8, 2), generator=gen, device="cuda")
    noise = F.interpolate(noise, size=(h, w), mode="bilinear").permute(0, 2, 3, 1)
    return (torch.stack((gx, gy), -1)[None] + 0.1 * noise).contiguous()


def corr_cases(gen):
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    out = []
    for label, hw, c, r in CORR_SHAPES:
        f0, f1, w = rn(2, hw, hw, c), rn(2, hw, hw, c), smooth_warp(gen, 2, hw, hw)
        out.append((label, (f0, f1, r, w), ops.local_correlation_reference(f0, f1, r, w)))
    return out


def stack_cases(gen):
    f = lambda *s, scale=1.0, shift=0.0: shift + scale * torch.randn(*s, generator=gen, device="cuda")
    c = 24
    blocks = [ops.fold_block(f(c, 1, 5, 5, scale=0.2), f(c, scale=0.1), f(c, scale=0.1, shift=1.0),
                             f(c, scale=0.1), f(c, scale=0.05), f(c, scale=0.2, shift=1.0).abs(),
                             f(c, c, 1, 1, scale=1.5 / c**0.5), f(c, scale=0.1)) for _ in range(9)]
    out = []
    for hw in (560, 864):
        x = torch.randn(2, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        out.append((f"s1 {hw}^2 C24 x9", (x, blocks), ops.refiner_stack_reference(x, blocks)))
    return out


def corr_call(lib, args, out):
    f0, f1, r, w = args
    b, h, ww, c, nv = corr_checks("kernel_variants", f0, f1, r, w)
    fn = lib.roma_local_corr
    fn.argtypes, fn.restype = [P, P, P, P, I, I, I, I, I, I, I, P], I
    ptrs = (f0.data_ptr(), f1.data_ptr(), w.data_ptr(), out.data_ptr())

    def call():
        if fn(*ptrs, b, h, ww, c, r, nv, 1, _ext.stream()):
            raise RuntimeError("roma_local_corr failed")
        return out
    return call


def stack_call(lib, args, out):
    x, blocks = args
    b, h, w, c = x.shape
    fn = lib.roma_refiner_block
    fn.argtypes, fn.restype = [P, P, P, P, P, P, I, I, I, I, I, I, P], I
    bufs = (out, torch.empty_like(x))

    def call():
        y = x
        for i, blk in enumerate(blocks):
            o = bufs[(i + len(blocks) + 1) % 2]  # the last block lands in out
            if fn(y.data_ptr(), *(blk[k].data_ptr() for k in ("dw", "db", "w2", "b2")), o.data_ptr(),
                  b, h, w, c, 5, 1, _ext.stream()):
                raise RuntimeError("roma_refiner_block failed")
            y = o
        return y
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS), help="the variants to time (default: all)")
    names = ap.parse_args(argv).only or list(VARIANTS)
    require_card("cuda")
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"local_corr.cu": (corr_cases(gen), corr_call), "refiner_stack.cu": (stack_cases(gen), stack_call)}
    for name in names:
        lib = ctypes.CDLL(str(libs[name].resolve()))
        shapes, make = cases[VARIANTS[name][0]]
        total, err = 0.0, 0.0
        for label, args, ref in shapes:
            call = make(lib, args, torch.empty_like(ref))
            got = call()
            torch.cuda.synchronize()
            err = max(err, (got.float() - ref.float()).abs().max().item())
            ms = graph_ms(call)
            total += ms
            print(f"{name:20s} {label:28s} device {ms:.4f} ms", flush=True)
        print(f"{name:20s} {'total':28s} device {total:.4f} ms  max|kernel - plain| {err:.3e}", flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
