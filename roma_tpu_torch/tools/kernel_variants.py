"""Variants of Kernels B, C, D, H, I, J, K and L timed against the sources as they stand.

    python3 -m roma_tpu_torch.tools.kernel_variants [--only NAME ...]

Each variant is a copy of ``csrc/local_corr.cu``, ``csrc/warp_sample.cu``,
``csrc/refiner_stack.cu``, ``csrc/refiner_chain.cu``,
``csrc/wide_refiner.cu`` or ``csrc/onehot_dots.cu`` with named text
replaced (VARIANTS), built alone by nvcc into
``build/kernel_variants/<name>.so`` (all builds in parallel) and called
through its C entry on bf16 inputs at the shapes chip_smoke.py gives the
kernel (B's five local-correlation scales, C's nine x_hat lookups, D's and
H's 9-block scale-1 stacks at 560^2 and 864^2, the same inputs for both;
I's and J's seven 9-block wide-C stacks, NHWC for I, (B, H, C, W) for J;
B = 2; K's two entries and L at tools/bench_onehot_dots.py's sizes). For
each it prints the device time of each shape (calls captured in a CUDA
graph and replayed, the median over replays), their sum, and the largest
difference from the plain version; then the card line. The variants are
the choices the redesigns weighed; "b", "c", "d", "h", "i", "j", "k" and
"l" are the sources unchanged. H's group size and K's path are arguments
of their entries (H_GROUPS, K_PATHS).
"i_permute_j" is the yardstick for I: x permuted to (B, H, C, W), J's
chain, the result permuted back, all in the timed call. Needs a CUDA card
and nvcc.
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
from ..ops.onehot_dots import onehot_checks, window_sum_checks
from ..ops.refiner_stack import C24_GROUP, packed_weights
from ..ops.warp_sample import PATH_CODES, warp_sample_checks
from ..ops.wide_refiner import block_w2t
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
    # C: lanes a query on the vector path (in bf16 C = 512 takes 32 lanes of
    # 2 vectors, C = 256 16 lanes of 2; here one vector a lane, or two only
    # from C = 512)
    "c": ("warp_sample.cu", []),
    "c_one_vector_a_lane": ("warp_sample.cu", [("if (L >= 32 && L % 2 == 0) {", "if (false) {")]),
    "c_two_vectors_from_c512": ("warp_sample.cu", [("if (L >= 32 && L % 2 == 0) {", "if (L >= 64 && L % 2 == 0) {")]),
    # J: the pixels a block, the input channels a w2 tile, the pipelines' depth
    "j": ("wide_refiner.cu", []),
    "j_one_row_a_block": ("wide_refiner.cu", [
        ("if (!try_hcw<64, 4, 48>(ROMA_HCW_ARGS) && !try_hcw<64, 2, 64>(ROMA_HCW_ARGS) &&\n      "
         "!try_hcw<32, 2, 64>(ROMA_HCW_ARGS) && ", "if (")]),
    "j_no_2x32": ("wide_refiner.cu", [("!try_hcw<32, 2, 64>(ROMA_HCW_ARGS) && ", "")]),
    "j_tile48_everywhere": ("wide_refiner.cu", [(", 64>(ROMA_HCW_ARGS)", ", 48>(ROMA_HCW_ARGS)")]),
    "j_tile64_at_c144": ("wide_refiner.cu", [("try_hcw<64, 4, 48>", "try_hcw<64, 4, 64>")]),
    "j_depth2": ("wide_refiner.cu", [("constexpr int DEPTH = 3;", "constexpr int DEPTH = 2;")]),
    "j_no_8byte_staging": ("wide_refiner.cu", [("err = W % 4 == 0   ?", "err = false ?")]),
    # I: the permute + J + permute yardstick, no 2 x 32 block at C = 1137
    # (the shared-memory limit on the pixels a block)
    "i": ("wide_refiner.cu", []),
    "i_permute_j": ("wide_refiner.cu", []),
    "i_no_2x32": ("wide_refiner.cu", [("!try_nhwc<32, 2, 64>(ROMA_NHWC_ARGS) && ", "")]),
    # H: blocks a launch (H_GROUPS) and the tile's rows (16 or 32)
    "h": ("refiner_chain.cu", []),
    "h_g1": ("refiner_chain.cu", []),
    "h_g3": ("refiner_chain.cu", []),
    "h_rows32": ("refiner_chain.cu", [("constexpr int TH = 16;", "constexpr int TH = 32;")]),
    "h_g3_rows32": ("refiner_chain.cu", [("constexpr int TH = 16;", "constexpr int TH = 32;")]),
    # J's two phases alone (timing probes: the output is wrong)
    "j_probe_depthwise_only": ("wide_refiner.cu", [("for (int i = 0; i < nst; ++i) {", "for (int i = 0; i < 0; ++i) {")]),
    "j_probe_product_only": ("wide_refiner.cu", [("for (int ch = 0; ch < nch; ++ch) {", "for (int ch = 0; ch < 0; ++ch) {")]),
    # K: a thread a query (the scalar path at T % 4 == 0), the queries a block
    "k": ("onehot_dots.cu", []),
    "k_one_query_a_thread": ("onehot_dots.cu", []),
    "k_chunk1024": ("onehot_dots.cu", [("KCHUNK = 4096;", "KCHUNK = 1024;")]),
    # K's query stream alone (a timing probe: every block stages tile 0's
    # column, from L2, so the output is wrong)
    "k_probe_one_column": ("onehot_dots.cu", [("win + (long long)tile * WH * CWW;", "win;")]),
    # L: phase 1 over every table row (no zeroed scratch, no marking pass),
    # the loads a lane keeps in flight
    "l": ("onehot_dots.cu", []),
    "l_all_rows": ("onehot_dots.cu", [
        (" || rowsum[row] == 0.f) return;", ") return;"),
        ("  cudaError_t err = cudaMemsetAsync(rs, 0, nrows * sizeof(float), s);\n"
         "  if (err) return static_cast<int>(err);\n"
         "  mark_rows_kernel<<<static_cast<unsigned>(mark_blocks), LT, 0, s>>>(y, j, b, rs, n, B, HP, NJ, WH, NS);\n",
         "")]),
    "l_unroll4": ("onehot_dots.cu", [("L_UNROLL = 8;", "L_UNROLL = 4;")]),
}
WARP_SHAPES = (("coarse s16 40^2 C512", 40, 512), ("coarse s8 70^2 C512", 70, 512),
               ("coarse s4 140^2 C256", 140, 256), ("coarse s2 280^2 C64", 280, 64),
               ("coarse s1 560^2 C9", 560, 9), ("upsample s8 108^2 C512", 108, 512),
               ("upsample s4 216^2 C256", 216, 256), ("upsample s2 432^2 C64", 432, 64),
               ("upsample s1 864^2 C9", 864, 9))
# chip_smoke.py's WIDE_SHAPES: (label, H = W, C)
WIDE_SHAPES = (("coarse s16 35^2 C1377", 35, 1377), ("coarse s8 70^2 C1137", 70, 1137),
               ("coarse s4 140^2 C569", 140, 569), ("coarse s2 280^2 C144", 280, 144),
               ("upsample s8 108^2 C1137", 108, 1137), ("upsample s4 216^2 C569", 216, 569),
               ("upsample s2 432^2 C144", 432, 144))
CORR_SHAPES = (("coarse s16 40^2 C512 r7", 40, 512, 7), ("coarse s8 70^2 C512 r3", 70, 512, 3),
               ("coarse s4 140^2 C256 r2", 140, 256, 2), ("upsample s8 108^2 C512 r3", 108, 512, 3),
               ("upsample s4 216^2 C256 r2", 216, 256, 2))
# H's variants' blocks a launch (default: ops.refiner_stack.C24_GROUP)
H_GROUPS = {"h_g1": 1, "h_g3": 3, "h_g3_rows32": 3}
# K's variants' path (default: the plan of onehot_checks)
K_PATHS = {"k_one_query_a_thread": "scalar"}
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


def warp_cases(gen):
    out = []
    for label, hw, c in WARP_SHAPES:
        y = torch.randn(2, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        w = smooth_warp(gen, 2, hw, hw)
        out.append((label, (y, w), ops.warp_sample_reference(y, w)))
    return out


def wide_cases(gen):
    from .bench_hcw_refiner import make_modules

    out = []
    for label, hw, c in WIDE_SHAPES:
        with torch.no_grad():
            mods = make_modules(c, gen, "cuda")
            blocks = ops.fold_refiner(mods[0], mods[1:])
        x = torch.randn(2, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        ref = ops.wide_refiner_stack_reference(x, blocks).permute(0, 1, 3, 2).contiguous()
        out.append((label, (x.permute(0, 1, 3, 2).contiguous(), blocks), ref))
        del mods, x
    return out


def lane_cases(gen):
    """wide_cases' stacks on NHWC x (Kernel I)."""
    return [(label, (x.permute(0, 1, 3, 2).contiguous(), blocks), ref.permute(0, 1, 3, 2).contiguous())
            for label, (x, blocks), ref in wide_cases(gen)]


def wide_chain(lib, x, blocks, out, layout, path):
    """A call running the 9-block chain through roma_wide_refiner_block,
    the last block into out."""
    b, h = x.shape[:2]
    c, w = (x.shape[2], x.shape[3]) if layout == 1 else (x.shape[3], x.shape[2])
    fn = lib.roma_wide_refiner_block
    fn.argtypes, fn.restype = [P] * 6 + [I] * 7 + [P], I
    bufs = (out, torch.empty_like(x))
    w2s = [block_w2t(blk) for blk in blocks]  # made once, outside the timed calls, as the wrapper keeps them

    def call():
        y = x
        for i, (blk, w2) in enumerate(zip(blocks, w2s)):
            o = bufs[(i + len(blocks) + 1) % 2]  # the last block lands in out
            if fn(y.data_ptr(), blk["dw"].data_ptr(), blk["db"].data_ptr(), w2.data_ptr(), blk["b2"].data_ptr(),
                  o.data_ptr(), b, h, w, c, layout, path, 1, _ext.stream()):
                raise RuntimeError("roma_wide_refiner_block failed")
            y = o
        return y
    return call


def lane_call(lib, args, out, name):
    x, blocks = args
    if name != "i_permute_j":
        return wide_chain(lib, x, blocks, out, 0, 2)
    xt = torch.empty_like(x.permute(0, 1, 3, 2), memory_format=torch.contiguous_format)
    hcw = wide_chain(lib, xt, blocks, torch.empty_like(xt), 1, 1)

    def call():  # x to (B, H, C, W), J's chain, back to NHWC
        xt.copy_(x.permute(0, 1, 3, 2))
        out.copy_(hcw().permute(0, 1, 3, 2))
        return out
    return call


def chain_call(lib, args, out, name):
    x, blocks = args
    b, h, w, c = x.shape
    g = H_GROUPS.get(name, C24_GROUP)
    fn = lib.roma_refiner_chain
    fn.argtypes, fn.restype = [P] * 6 + [I] * 10 + [P], I
    ws = packed_weights(blocks)
    launches = -(-len(blocks) // g)
    bufs = (out, torch.empty_like(x))

    def call():
        y = x
        for j, i in enumerate(range(0, len(blocks), g)):
            o = bufs[(j + launches + 1) % 2]  # the last launch lands in out
            if fn(y.data_ptr(), *(t[i].data_ptr() for t in ws), o.data_ptr(), b, h, w, c, 5,
                  min(g, len(blocks) - i), 32, 8, 1, 1, _ext.stream()):
                raise RuntimeError("roma_refiner_chain failed")
            y = o
        return y
    return call


def warp_call(lib, args, out, name):
    y, w = args
    b, h, ww, c, hq, wq, path = warp_sample_checks("kernel_variants", y, w)
    fn = lib.roma_warp_sample
    fn.argtypes, fn.restype = [P, P, P, I, I, I, I, I, I, I, I, P], I
    ptrs = (y.data_ptr(), w.data_ptr(), out.data_ptr())

    def call():
        if fn(*ptrs, b, h, ww, c, hq, wq, PATH_CODES[path], 1, _ext.stream()):
            raise RuntimeError("roma_warp_sample failed")
        return out
    return call


def wide_call(lib, args, out, name):
    x, blocks = args
    return wide_chain(lib, x, blocks, out, 1, 1)


def corr_call(lib, args, out, name):
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


def stack_call(lib, args, out, name):
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


def onehot_cases(gen):
    """K's two entries on tools/bench_onehot_dots.py's e1 inputs."""
    from .bench_onehot_dots import e1_inputs

    win, yl, fy = e1_inputs(gen)
    ref = ops.onehot_dot_reference(win, yl, fy)
    return [(f"E1 {form}", (win, yl, fy, form), ref) for form in ops.onehot_dots.FORMS]


def onehot_call(lib, args, out, name):
    win, yl, fy, form = args
    nt, wh, cww, t, path, _ = onehot_checks("kernel_variants", win, yl, fy, form)
    fn = lib.roma_onehot_dot
    fn.argtypes, fn.restype = [P] * 4 + [I] * 6 + [P], I
    ptrs = (win.data_ptr(), yl.data_ptr(), fy.data_ptr(), out.data_ptr())
    vec = int(K_PATHS.get(name, path) == "vector")

    def call():
        if fn(*ptrs, nt, wh, cww, t, int(form == "2bf16"), vec, _ext.stream()):
            raise RuntimeError("roma_onehot_dot failed")
        return out
    return call


def window_cases(gen):
    """L on tools/bench_onehot_dots.py's e2 inputs."""
    from .bench_onehot_dots import NS, WH, e2_inputs

    tab, oy, jx, img = e2_inputs(gen)
    return [("E2", (tab, oy, jx, img, WH, NS), ops.window_sum_reference(tab, oy, jx, img, WH, NS))]


def window_call(lib, args, out, name):
    tab, oy, jx, img, wh, ns = args
    b, hp, nj, xqc, nt, nrows = window_sum_checks("kernel_variants", tab, oy, jx, img, wh, ns)
    fn = lib.roma_window_sum
    fn.argtypes, fn.restype = [P] * 6 + [I] * 7 + [P], I
    rowsum = torch.empty(nrows, device=tab.device)
    ptrs = (tab.data_ptr(), oy.data_ptr(), jx.data_ptr(), img.data_ptr(), rowsum.data_ptr(), out.data_ptr())

    def call():
        if fn(*ptrs, nt, b, hp, nj, xqc, wh, ns, _ext.stream()):
            raise RuntimeError("roma_window_sum failed")
        return out
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
    # a variant's kernel is the letter before its first "_"; D and H share
    # their inputs
    makers = {"b": (corr_cases, corr_call), "c": (warp_cases, warp_call), "d": (stack_cases, stack_call),
              "h": (stack_cases, chain_call), "i": (lane_cases, lane_call), "j": (wide_cases, wide_call),
              "k": (onehot_cases, onehot_call), "l": (window_cases, window_call)}
    cases = {}
    for name in names:
        lib = ctypes.CDLL(str(libs[name].resolve()))
        inputs, make = makers[name.split("_")[0]]
        if inputs not in cases:  # inputs made once, only for the kernels asked for
            cases[inputs] = inputs(gen)
        shapes = cases[inputs]
        total, err = 0.0, 0.0
        for label, args, ref in shapes:
            call = make(lib, args, torch.empty_like(ref), name)
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
