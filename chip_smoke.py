#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (roma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels from roma_tpu_torch/csrc (nvcc,
   sm_90a, one nvcc per source in parallel) and prints the build time.
2. Checks each kernel against its plain PyTorch version at the shapes the
   560 -> 864 match and the 560^2 training step give it, in bfloat16 and in
   float32, and times both with CUDA events (median of 20 calls: the call
   time, the wrapper's host work included). The kernel and its library call
   also get a device time: calls captured in a CUDA graph and replayed
   between one pair of events (device_ms; see device_ms()). Kernel D is
   timed beside the model's eager cuDNN stack on the modules its blocks are
   folded from (stack_ms, stack_device_ms), and Kernel N, the depthwise
   half of each wide stack's blocks, beside the cuDNN depthwise, BatchNorm
   and ReLU modules it replaced. Kernel C must give its plain
   version's bits (check_bits, bf16 and f32). In bf16, A, B, C, D, E and N
   are also held to ULP_BARS, and for B, C, D and N a planted fault in the
   plain version must break that bar (check_power). The same checks and times
   then run at MEGA_SHAPES, A-D and N as MatchEngine launches them at batch 4 at
   Mega-1500's 672 -> 1344 canvas, into their own kernels line
   ("kernels_672to1344"). Right after, check_match_edges
   holds D, B and C off the main path's shapes: D's generic instantiation
   and ragged tiles, B's scalar path, idle lanes and every radius, C's three
   paths at other widths on a rectangular query grid under a flow far off
   the image (bitwise), and their vector paths refusing a misaligned base.
3. Checks the whole match on a small configuration: the kernel path on the
   card against the plain path on the CPU, same weights, float32; once with
   the defaults and once non-symmetric and coarse-only.
   Then the 672 -> 1344 phase (check_mega_engine): roma_outdoor at
   Mega-1500's canvas on seeded random weights through MatchEngine at
   batch 4 over a warm-up batch and 3 timed batches of MegaDepth-size JPEG
   pairs; every batch must launch 29 A, 5 B, 9 C, 18 D and 63 N and no other
   port kernel (those launches are the kernels_672to1344 line's), every result
   (1344, 2688) and finite; the timed pairs/s and peak memory printed.
4. Builds roma_outdoor at the released widths on seeded random weights
   (bf16 amp, 560 -> 864, symmetric), answers 3 match requests on seeded
   synthetic image pairs, samples 5000 matches from each, and checks shapes,
   finiteness, sample range and that every kernel of the match launched
   (M once a canvas a request, N 63 times a request: once a block of the
   wide stacks, scales 16-2 of both passes).
   Then the int8 phase (check_int8): int8_matmul on the card against the
   same call on the CPU bit for bit at INT8_SHAPES (the ViT's proj, fc1 and
   fc2 at 2 x 1601 tokens, each refiner width at 4 rows; bf16 and f32),
   one activation rounded the other way breaking each; roma_outdoor(
   vit_int8=True, refiner_int8=True) on the same seeded weights, 3 requests:
   shapes, finiteness, A-D launched (N not: the int8 stacks keep their
   modules) and int8_products_per_request (135)
   int8 products in each; its per-scale flow drift from the bf16 model
   (p50, p99, coarse anchor flip rate) and tools/int8_drift.py at full dims,
   printed; its pairs/s, latency and peak memory beside the bf16 model's,
   and one fc1 through the int8 path, its _int_mm alone and the bf16
   Linear, timed.
   Then the zoo phase (check_zoo): writes that model's weights as a
   reference-layout .pth pair, builds roma_outdoor and roma_indoor from the
   files, requires every loaded tensor to equal the file's and each match to
   equal the seeded model's to the bf16 bar, runs match_keypoints,
   conf_from_fb_consistency and visualize_warp on the output, and prints
   each load time and peak memory. The script sets ROMA_TPU_OFFLINE=1 and
   an empty ROMA_TPU_CACHE first, so no weights are fetched or read.
   Then the release phase (check_release): experiments/validate_release.py
   stages 1-4 on the zoo phase's files at RELEASE_RES (560 -> 864),
   released widths, stage 3's float32 plain pass on the host's CPU, the
   coarse classifier pinned by the peaked bias; each stage, the p99, the
   flipped anchors and the CPU pass's time printed.
   Then the serve phase (check_serving): MatchEngine at batch 4 over 9
   synthetic pairs written as PNG files and a 10th with a corrupt image
   (on_error="skip"): order, the error, the padded last batch, every batch
   row bitwise match()'s own preprocessing of its files, Kernels A-D
   launched in every batch, each result equal to model.match of its pair
   to the bf16 bar with the coarse classifier pinned by one peaked bias;
   then batch 8 over 24 pairs, timed (pairs/s, host prep, peak memory).
   Then the eval phase (check_eval): the capstone's 3 synthetic scenes
   (roma_tpu_torch.tools.crossimpl) through run_pose_benchmark on the
   native RANSAC, float32, against the JAX values of
   CROSSIMPL_AUC_TORCH.json (match error within 1e-3 px, AUC drawn on the
   host with the CPU capstone's keys within 0.5 pp); balanced_sample on the
   card against the CPU on identical uniforms; the card-drawn AUC@5 against
   the AUC@5 drawn from CPU generators, means over 40 seeds within 3
   standard errors; then bf16 amp within the file's amp bar of the float32
   AUC, both drawn on the card with the same keys.
   Then the Tiny RoMa phase (check_tiny; no TPU kernel lies on its path,
   so no port kernel may launch there), on seeded weights that keep the
   activations' scale (conditioned_tiny_weights): (a) the card against the
   CPU at 128x160, float32: the net exact and approximate on an equal and
   an unequal pair, match, and one training step (each gradient within
   1e-3 of its tensor's largest entry); (b) tiny_roma_v1_outdoor at the
   released architecture (2,842,490 parameters), 3 requests on 720x960
   synthetic pairs (704x960 inside) of match + sample(5000) +
   to_pixel_coordinates, float32 then bf16: shapes, finite values, samples
   in [-1, 1], latency, pairs/s and peak memory; (c) the zoo's seeded
   random weights written as a reference-layout tiny .pth and XFeat state
   dict and loaded again: every tensor equal to the files', the match bit
   for bit; (d) MatchEngine(tiny, batch_size=8, resize_hw=(704, 960),
   normalize=False) over 16 PNG pairs, each row against tiny.match of its
   resized arrays, then timed; (e) 5 training steps at the recipe's
   768x1024, batch 8, bf16 autocast: finite losses, XFeat's parameters and
   statistics unchanged, the matchers' statistics moved, step time,
   samples/s and peak memory. Comparisons of the approximate path count the
   coarse cells whose argmax flipped between the two runs (near-ties) and
   set aside every cell within TINY_FLIP_RADIUS of one
   (compare_beside_flips): at most TINY_FLIPS of the cells may flip and
   their neighbourhoods may cover at most TINY_ASIDE of the pixels, the
   rest is held to the JAX package's bar against its torch spec.
5. Checks one training step on the small configuration: the kernel path on
   the card against the plain path on the CPU, float32; on the card once as
   it is and once under remat (RoMaNet(remat=True)).
6. Trains the released widths (DINOv2 frozen, bf16 autocast over float32
   parameters, 560^2, batch 4, the recipe's losses and optimizer) for 5
   steps on synthetic batches, and checks the losses, the gradients, the
   frozen backbone, the updates and the kernel launches.
   Then the recipe phase (check_recipe): the training recipe of
   roma_tpu_torch.experiments.train_roma_outdoor end to end. The card's
   Python has no h5py, so the data is a ScanNet-format tree written here
   (write_scannet_tree: 3 scenes of 6 cameras on a line before a textured
   plane, 90 pairs, 640x480 JPEG colour and 16-bit PNG depth) in place of
   MegaDepth's bands. build() at the recipe's shape (medium 560^2,
   --gpu_batch_size 8, remat, bf16 autocast, --no-pretrained_backbone,
   --distributed) joins a one-rank nccl process group from torchrun's
   environment variables; 5 steps from the loader (thread-pool decode,
   pinned copies): finite losses, samples/s after the first step
   (StepTimer), the host's wait on the loader a step, A and E at their
   remat counts (train_launches), B-D not launched; peak memory with remat,
   then one step without remat at batch 8, whose peak must be higher;
   resume: save, build() again (which loads the newest checkpoint), the
   state equal to the saved one, one step on the same batch from both
   within 1e-3 of the parameters' largest entry (the gather backward's
   atomics keep it from being bitwise); then MegadepthDenseBenchmark over
   the tree at batch 8 (16 pairs): EPE and PCK finite and in range, its
   wall time, A-D launched.
   Then the convergence phase (check_convergence): tools/convergence_run.py
   at RoMaConfig.small() (head dims of 64: A and E), 112^2, batch 8, 100
   steps of the full recipe on analytic textured-plane pairs, in this
   process: no non-finite gradient step, finite BatchNorm statistics, the
   loss down, PCK@5 up, A and E launched as the steps and evaluations need.
   Then the replicas phase (check_replicas): MatchEngine(batch_size=8,
   devices=["cuda:0", "cuda:0"]) against MatchEngine(batch_size=4) over 24
   pairs at released widths, pinned by the peaked bias: each pair to the
   bf16 bar, A-D in every replica's call, pairs/s and peak memory of both.
7. Runs the per-head attention op (ops.sdpa) forward and backward as a
   caller does, at the DINOv2 shape.
   Right after 2, holds the bf16 tensor-core attention kernels (A, E) at
   their edges: registers and spills from the build's ``-Xptxas -v``
   report (a spill fails), ragged shapes and a packed view against the
   plain versions, two runs of E at the full-width decoder shape bitwise
   equal, and misaligned bf16 views refused with ValueError.
8. Right after 2, checks the windowed samplers and the packed refiner
   stack at their design shapes (B = 2, bf16 and f32): Kernel F (compact_miss) exactly
   against its plain version on its own path and on the generic one, a
   planted off-by-one rank breaking that check; Kernel G's two entries against their plain
   tile computation, bit for bit, and windowed_warp / windowed_grid_sample as a whole
   against warp_sample_reference, asserting which branch each case took;
   Kernel H against refiner_stack_reference and Kernel D (in bf16 to
   H_ULPS, with a planted fault), timed beside D; times G's
   wrapper part by part on the host (wrapper_host_parts). Then holds G at
   its edges: a v1 partial tile (560^2), fixups at a tile's first and last
   query and on both sides of a block boundary, and widths other than 9
   (the instantiated 4 and 5, and 3 through the looped kernel); and F at
   COMPACT_EDGES on each of its paths, views off the vector alignment on
   the generic one and the entry refusing a vector path there. After 7,
   drives those entries once as a caller does and counts F, G and H's
   launches.
9. Right after 8, checks Kernels I and J (the wide-C refiner blocks)
   against wide_refiner_stack_reference at the seven shapes the 560 -> 864
   match gives the wide-C stacks (B = 2, 9 blocks folded from refiner_block
   modules, bf16 and f32; in bf16 also to their ulp bars, with a planted
   fault) and times them beside the plain version and the model's own
   cuDNN block stack on the same modules (call and device time); then
   check_wide_edges holds J, I and H at other widths and sizes (J_EDGES,
   I_EDGES, H_EDGES), asserts the path each takes and refuses misaligned
   views; then Kernel K's two
   entries and Kernel L against their plain versions at
   tools/bench_onehot_dots.py's sizes: K's f32 entry and L to the f32 bar,
   K's 2bf16 entry bit for bit, a planted fault in each plain version
   (FAULTS: K's weights swapped, L's windows a row down) breaking the f32
   bar; K timed beside F.grid_sample on its column 0 (onehot_library), L
   beside one index_select + sum, with the expected rounding error of its
   two-level sum (window_sum_rms_error). Then check_onehot_edges holds K at
   K_EDGES (yl of -1, WH - 1 and past WH; T % 4 != 0; WH 5 and 300; one
   tile) and L at L_EDGES (windows off the table give NaN; XQC = 8; NS = 1;
   one tile; a row of 513 vectors), asserts the path each K case takes and
   the NaN tiles of each L case, requires L's misaligned tab (base 2 bytes
   off 16) refused, and holds K's misaligned yl and fy (4 and 8 bytes off,
   T % 4 == 0) to its plain version on the scalar path, which they must
   take. After 8's caller run,
   drives lane_refiner_stack, hcw_refiner_stack and the port tools' e1 /
   e2 once as a caller does and counts I, J, K and L's launches.
   Right after 9, the resize phase (check_resize): Kernel M through the
   card tests of tests/test_torch_resize.py (bit for bit its plain version
   over the sweep; match()'s inputs bit for bit the PIL path's, float32 and
   bf16; unsynchronized matches equal to synchronized ones), then timed at
   the single-pair shapes beside PIL's host resize of the same images.
10. Prints one JSON line of per-kernel results (each kernel's launches are
   counted over the phase of 4, 6, 7, 8 or 9 that runs it, plus, for A and
   E, the convergence phase's and, for A-D, the replicas phase's; its bound_ms is the
   least time the card could take for the same work, from the bytes each
   input and output moves once and the operations over the peaks below;
   library_ms is one PyTorch call that computes the same function, where
   there is one; device_ms and library_device_ms are their device times,
   device_by the method), the card's name and power limit, and as the last line
   {"ok": true, "device": {...}}.

With ``--profile``, 4 and 6 each trace one more request (the last pair
again) and one more step (the last batch again) with torch.profiler, after
their counted runs (the Tiny phase one more request in each dtype and one
more step), and print the wall and device time of each, the card's
idle share, the top kernels and the port's kernels by letter.

Any failure exits non-zero before the last line is printed. Without a CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import importlib.metadata
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise SmokeFailure(what)

# bf16 check of every kernel: the kernel and its plain version round to
# bf16 at the same kinds of places but sum in another order, so an output may
# differ by a few bf16 ulps of the largest value.
BF16_REL, BF16_ABS = 3e-2, 1e-2
# f32 check (TF32 off everywhere): only the summation order differs.
F32_REL = 1e-4
# Some bf16 kernels are held to a second bar as well, ULP_BARS[name] bf16
# ulps of the largest reference value, and check_power asserts at every
# full-width shape that one planted fault in the plain version breaks it.
# Attention (A, E), on inputs at the model's logit scale (q and k drawn so
# that q.k / sqrt(D) has std LOGIT_STD): Kernel A rounds the unnormalized
# softmax numerators to bf16 for P.V and divides by their f32 sum after it,
# sdpa_reference rounds the normalized probabilities; Kernel E and
# attention_backward_reference both round P and dS. Either way an output
# moves by up to two ulps of the largest value (measured on an H100), while
# a softmax scale off by 2% moves it by 5.5 or more.
ATTN_ULPS = 4
LOGIT_STD = 2.0
# D and B round where their plain versions round (D: t and each block's
# output; B: the output), so only f32 summation orders differ: a rounding
# flip moves an output by one ulp of itself, and D carries a flip on
# through its later blocks. Measured on an H100 at the full-width shapes:
# D 0 to 1 ulp, B at most 0.5; the planted faults (FAULTS) move the plain
# versions by 125 ulps or more.
D_ULPS = 4
B_ULPS = 4
# Kernel C is held to its plain version's bits (check_bits); its ulp bar is
# there so that check_power shows the comparison can fail. Kernel J rounds
# where its plain version rounds (t, w2 and each block's output), so only f32
# summation orders differ, as for D: the PR 7 kernel measured 1.4 to 2 ulps
# at WIDE_SHAPES on an H100, the planted fault 121 or more (PERF.md, PR 8).
C_ULPS = 4
J_ULPS = 4
# Kernels I and H round where their plain versions round (I as J; H as D,
# its group's planes in bf16 holding the already rounded block outputs), so
# only f32 summation orders differ.
I_ULPS = 4
H_ULPS = 4
# Kernel N rounds once, where its plain version rounds, after an f32 sum of
# 25 taps and the bias in another order: one ulp of the largest value.
N_ULPS = 1
ULP_BARS = {"fused_attention_packed": ATTN_ULPS, "fused_attention": ATTN_ULPS,
            "fused_attention_backward": ATTN_ULPS, "fused_refiner_stack": D_ULPS, "local_correlation": B_ULPS,
            "warp_sample": C_ULPS, "hcw_refiner_block": J_ULPS, "lane_refiner_block": I_ULPS,
            "fused_refiner_stack_packed": H_ULPS, "depthwise_bn_relu": N_ULPS}
# the kernels of kernel_cases held to their plain version bit for bit
BITWISE = ("warp_sample",)

KERNEL_INFO = {
    "fused_attention_packed": ("roma_tpu_torch/csrc/attention.cu", "roma_tpu/ops/pallas_attention.py:259"),
    "local_correlation": ("roma_tpu_torch/csrc/local_corr.cu", "roma_tpu/ops/tile_window.py:516"),
    "warp_sample": ("roma_tpu_torch/csrc/warp_sample.cu", "roma_tpu/ops/lane_warp.py:106"),
    "fused_refiner_stack": ("roma_tpu_torch/csrc/refiner_stack.cu", "roma_tpu/ops/pallas_refiner.py:111"),
    "fused_attention_backward": ("roma_tpu_torch/csrc/attention_bwd.cu", "roma_tpu/ops/pallas_attention.py:79"),
    "fused_attention": ("roma_tpu_torch/csrc/attention.cu", "roma_tpu/ops/pallas_attention.py:54"),
    "compact_miss": ("roma_tpu_torch/csrc/compact_miss.cu", "roma_tpu/ops/window_util.py:26"),
    "warp_tiles": ("roma_tpu_torch/csrc/window_warp.cu", "roma_tpu/ops/tile_window.py:123"),
    "warp_tiles_v1": ("roma_tpu_torch/csrc/window_warp.cu", "graveyard/window_warp_v1.py:86"),
    "fused_refiner_stack_packed": ("roma_tpu_torch/csrc/refiner_chain.cu", "roma_tpu/ops/pallas_refiner.py:279"),
    "lane_refiner_block": ("roma_tpu_torch/csrc/wide_refiner.cu", "graveyard/pallas_refiner_lanemajor.py:34"),
    "hcw_refiner_block": ("roma_tpu_torch/csrc/wide_refiner.cu", "graveyard/pallas_hcw_refiner.py:70"),
    "onehot_dot": ("roma_tpu_torch/csrc/onehot_dots.cu", "tools/bench_onehot_dots.py:44"),
    "window_sum": ("roma_tpu_torch/csrc/onehot_dots.cu", "tools/bench_onehot_dots.py:119"),
    "resize_normalize": ("roma_tpu_torch/csrc/resize.cu", "none: PIL's resize on the host"),
    "depthwise_bn_relu": ("roma_tpu_torch/csrc/depthwise.cu", "none: cuDNN's depthwise, BatchNorm and ReLU passes"),
}
# Kernel K's two entries, each the port of one TPU kernel body
ONEHOT_ENTRIES = (("f32", "onehot_dot_f32", "tools/bench_onehot_dots.py:44"),
                  ("2bf16", "onehot_dot_2bf16", "tools/bench_onehot_dots.py:61"))
# the kernels each driven phase must launch; the training step must launch
# none of the forward-only ones
MATCH_KERNELS = ("fused_attention_packed", "local_correlation", "warp_sample", "fused_refiner_stack")
# Kernel N, the depthwise half of every block of the wide stacks (scales
# 16-2) in inference: 4 stacks of 9 blocks in the coarse pass and 3 in the
# upsample pass, a request or an engine batch; none on the int8 stacks
WIDE_KERNEL, WIDE_LAUNCHES = "depthwise_bn_relu", 63
TRAIN_KERNELS = ("fused_attention_packed", "fused_attention_backward")


def train_launches(cfg, remat: bool) -> dict:
    """A and E's launches in one training step: A for DINOv2's blocks and
    the decoder's, whose forward runs again in the backward under remat (the
    recipe's default); E once a decoder block."""
    return {"fused_attention_packed": cfg.dino_depth + (2 if remat else 1) * cfg.decoder_depth,
            "fused_attention_backward": cfg.decoder_depth}


FORWARD_ONLY = ("local_correlation", "warp_sample", "fused_refiner_stack", WIDE_KERNEL)
RESIZE_CANVASES = ((560, 560), (864, 864))  # Kernel M's: roma_outdoor's coarse and upsample canvases
SDPA_KERNELS = ("fused_attention", "fused_attention_backward")
ATTENTION_KERNELS = ("fused_attention_packed", "fused_attention", "fused_attention_backward")
WINDOW_KERNELS = ("compact_miss", "warp_tiles", "warp_tiles_v1", "fused_refiner_stack_packed")
GRAVEYARD_KERNELS = ("lane_refiner_block", "hcw_refiner_block", "onehot_dot", "window_sum")

# the least time of a kernel's work: the larger of its bytes (each input read
# once, each output written once) over the memory rate and its operations
# over the peak for their type (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
KSIZE_N = 5  # Kernel N's depthwise size
PEAK_BF16_TENSOR = 989e12  # bf16 x bf16 products: attention, B's dot products in bf16
PEAK_F32 = 67e12  # CUDA cores: the rest (D and H's pointwise in f32 I/O; F's int ops; I and J's f32
# product and every depthwise)


@dataclass
class Case:
    """One kernel shape: the kernel and plain calls, the rows to compare,
    the work it must do (``ops`` at ``peak``, ``f32_ops`` on the CUDA cores
    beside them), and one PyTorch call computing the same function."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    rows: int | None = None
    bytes: float = 0.0
    ops: float = 0.0
    peak: float = PEAK_F32
    f32_ops: float = 0.0
    library: Callable | None = None
    library_graph: bool = True  # False: the library call cannot be captured (device_ms)
    stack: Callable | None = None  # several PyTorch calls computing the same function (D: the model's cuDNN stack)
    planted: Callable | None = None  # the plain version with one planted fault (FAULTS), for check_power

    def ops_ms(self) -> float:
        """The least time of the operations: tensor cores and CUDA cores run
        side by side, so the larger of their two times; one pipe, the sum."""
        if self.peak == PEAK_F32:
            return 1e3 * (self.ops + self.f32_ops) / PEAK_F32
        return 1e3 * max(self.ops / self.peak, self.f32_ops / PEAK_F32)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, call_ms: float, graph: bool = True, reps: int = 20) -> tuple[float, str]:
    """Device time of one call of ``fn``, without the host work around its
    launches: enough calls for ~2 ms (``call_ms`` is its call time)
    captured in one CUDA graph, the graph replayed ``reps`` times between
    pairs of events, the median over the calls in it ("graph"). A call that
    cannot be captured (``graph=False``: an autograd backward of a forward
    made outside the capture) is timed by torch.profiler instead: its
    kernels' summed device time over ``reps`` calls ("profiler")."""
    import torch

    if not graph:
        return profiled_ms(fn, reps), "profiler"
    inner = max(1, min(20, round(2.0 / max(call_ms, 1e-3))))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    times = []
    for _ in range(reps if call_ms < 5 else max(3, reps // 4)):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del g
    times.sort()
    return times[len(times) // 2], "graph"


def profiled_ms(fn, reps: int) -> float:
    """The device time of ``reps`` calls of ``fn`` under torch.profiler (the
    CUDA kernels' and copies' self times), over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    total_us = sum(map(self_device_us, events))
    require(total_us > 0, "profiled_ms: the trace shows no device time")
    return total_us / 1e3 / reps


def self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))


def smooth_flow(gen, b, h, w, off_band=True, scale=0.1):
    """Identity warp + smooth noise of amplitude ``scale``, with a band of
    rows pushed off-image."""
    import torch
    import torch.nn.functional as F

    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device="cuda")
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device="cuda")
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    noise = torch.randn(b, 2, max(h // 8, 2), max(w // 8, 2), generator=gen, device="cuda")
    noise = F.interpolate(noise, size=(h, w), mode="bilinear").permute(0, 2, 3, 1)
    f = torch.stack((gx, gy), -1)[None] + scale * noise
    if off_band:
        f[:, : h // 10, :, 1] -= 2.5
    return f.contiguous()


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def attn_qkv(rn, b, n, c, n_valid=None):
    """A packed (B, N, 3C) [q | k | v] at the model's logit scale: q and k
    at std sqrt(LOGIT_STD), v at 1; tokens at or past n_valid scaled by 5,
    content that must stay inert."""
    qkv = rn(b, n, 3 * c)
    qkv[..., : 2 * c] *= LOGIT_STD ** 0.5
    qkv[:, n_valid or n:] *= 5.0
    return qkv


def attn_heads(rn, b, h, n, d, n_valid=None):
    """(B, H, N, D) q, k, v drawn as attn_qkv draws them."""
    q, k, v = (LOGIT_STD ** 0.5 * rn(b, h, n, d), LOGIT_STD ** 0.5 * rn(b, h, n, d), rn(b, h, n, d))
    for t in (q, k, v):
        t[:, :, n_valid or n:] *= 5.0
    return q, k, v


def sdpa_library(q, k, v, n_valid):
    """F.scaled_dot_product_attention on (B, H, N, D) views, keys at or past
    n_valid masked out by a boolean key mask."""
    import torch
    import torch.nn.functional as F

    mask = None if n_valid is None else (torch.arange(q.shape[2], device=q.device) < n_valid).view(1, 1, 1, -1)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def grid_sample_library(x, flow):
    """F.grid_sample on the NCHW copy of x (made here, outside any timed
    window) with the flow in x's dtype, as the call requires."""
    import torch.nn.functional as F

    xn, g = x.permute(0, 3, 1, 2).contiguous(), flow.to(x.dtype)
    return lambda: F.grid_sample(xn, g, mode="bilinear", padding_mode="zeros", align_corners=False)


def refiner_blocks(gen, c=24, n=9, k=5, device="cuda"):
    """n folded refiner blocks of width c, depthwise k x k (Kernels D and H)."""
    import torch

    from roma_tpu_torch import ops

    f = lambda *s, scale=1.0, shift=0.0: shift + scale * torch.randn(*s, generator=gen, device=device)
    return [ops.fold_block(f(c, 1, k, k, scale=0.2), f(c, scale=0.1), f(c, scale=0.1, shift=1.0),
                           f(c, scale=0.1), f(c, scale=0.05), f(c, scale=0.2, shift=1.0).abs(),
                           f(c, c, 1, 1, scale=1.5 / c**0.5), f(c, scale=0.1)) for _ in range(n)]


def refiner_cost(x, blocks):
    """(bytes, pointwise ops, depthwise ops) of a folded stack: each block's
    input and output once plus its weights; per pixel and block a CxC
    pointwise and a KxK depthwise product, 2 ops per FMA."""
    b, h, w, c = x.shape
    k = blocks[0]["dw"].shape[0]
    n, npx = len(blocks), b * h * w
    return (n * (2 * x.numel() * x.element_size() + 4 * (k * k * c + c * c + 2 * c)),
            2 * n * npx * c * c, 2 * n * npx * k * k * c)


def packed_cost(x, blocks):
    """(bytes, pointwise ops, depthwise ops, the pointwise's peak, body) of
    Kernel H on a folded stack: the function's bytes (x read once, the
    output written once, the weights); the pointwise at the tensor cores'
    peak on the c24k5 body (two bf16 products), else on the CUDA cores; the
    depthwise on the CUDA cores."""
    from roma_tpu_torch.ops.refiner_stack import packed_checks

    *_, path, _ = packed_checks("packed_cost", x, blocks)
    _, pw_ops, dw_ops = refiner_cost(x, blocks)
    c, k = x.shape[-1], blocks[0]["dw"].shape[0]
    nbytes = 2 * x.numel() * x.element_size() + len(blocks) * 4 * (k * k * c + c * c + 2 * c)
    return nbytes, pw_ops, dw_ops, PEAK_BF16_TENSOR if path == "c24k5" else PEAK_F32, path


def refiner_edge_clamped(x, blocks, round_w2=False):
    """refiner_stack_reference (``round_w2`` as there) with one planted
    fault: the depthwise conv pads by repeating the image's edge instead of
    with zeros."""
    import torch
    import torch.nn.functional as F

    dt, c = x.dtype, x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    for blk in blocks:
        p = blk["dw"].shape[0] // 2
        t = F.conv2d(F.pad(y.float(), (p, p, p, p), mode="replicate"), blk["dw"].permute(2, 0, 1)[:, None],
                     blk["db"], groups=c)
        t = torch.relu(t).to(dt).float()
        w2 = blk["w2"].to(dt).float() if round_w2 else blk["w2"]
        y = F.conv2d(t, w2.T[:, :, None, None], blk["b2"]).to(dt)
    return y.permute(0, 2, 3, 1)


def depthwise_tap_dropped(x, dw, db):
    """depthwise_bn_relu_reference with one planted fault: the centre tap's
    weight left out."""
    from roma_tpu_torch.ops import depthwise_bn_relu_reference

    dw = dw.clone()
    dw[dw.shape[0] // 2, dw.shape[1] // 2] = 0
    return depthwise_bn_relu_reference(x, dw, db)


def warp_fractions_swapped(y, flow):
    """warp_sample_reference with one planted fault: the bilinear weights
    take fx for fy and fy for fx."""
    import torch

    b, h, w, c = y.shape
    ix = (flow[..., 0] + 1) * w / 2 - 0.5
    iy = (flow[..., 1] + 1) * h / 2 - 0.5
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fy, fx = (ix - x0f)[..., None], (iy - y0f)[..., None]  # the fault
    x0, y0 = x0f.long(), y0f.long()
    flat = y.reshape(b * h * w, c)
    base = torch.arange(b, device=y.device).view(b, 1, 1) * (h * w)
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        out = out + flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)].float() * (wgt * valid)
    return out.to(y.dtype)


def corr_fractions_swapped(f0, f1, radius, warp):
    """local_correlation_reference with one planted fault: the bilinear fold
    takes fx for fy and fy for fx."""
    from roma_tpu_torch.ops import local_corr as lc

    y0, x0, fy, fx = lc._base_indices(warp, f0.shape[1], f0.shape[2])
    return lc.bilinear_fold(lc.integer_tap_dots(f0, f1, radius, y0, x0), fx, fy).to(f0.dtype)


def onehot_weights_swapped(win, yl, fy):
    """onehot_dot_reference with one planted fault: the weights fy and
    1 - fy swapped."""
    from roma_tpu_torch import ops

    return ops.onehot_dot_reference(win, yl, 1.0 - fy)


def window_shifted_down(tab, oy, jx, img, wh, ns):
    """window_sum_reference with one planted fault: each window one table
    row further down."""
    from roma_tpu_torch import ops

    return ops.window_sum_reference(tab, oy + 1, jx, img, wh, ns)


def compact_rank_off_by_one(miss, t, kf):
    """compact_miss_reference with one planted fault: every rank one too
    high, so slot 0 holds the sentinel and slot s the s-th set flag."""
    import torch

    from roma_tpu_torch import ops

    ref = ops.compact_miss_reference(miss, t, kf)
    return torch.cat((torch.full_like(ref[:, :1], t), ref[:, :-1]), 1)


# what each Case.planted plants in its plain version
FAULTS = {"fused_refiner_stack": "edge-clamped instead of zero padding",
          "local_correlation": "fractions fy and fx swapped",
          "warp_sample": "fractions fy and fx swapped",
          "hcw_refiner_block": "edge-clamped instead of zero padding",
          "lane_refiner_block": "edge-clamped instead of zero padding",
          "fused_refiner_stack_packed": "edge-clamped instead of zero padding",
          "onehot_dot": "weights fy and 1 - fy swapped",
          "window_sum": "each window shifted down one table row",
          "compact_miss": "every rank one too high",
          "depthwise_bn_relu": "the centre tap dropped"}


# the main path's kernel shapes, by kernel: the single request's at 560 -> 864
# (one pair, B = 2 images). A: (label, tokens, heads, n_valid); B: (label,
# side, C, r); C: (label, side, C); D: (label, side), C = 24, 9 blocks
MATCH_SHAPES = {
    "batch": 2,
    "A": (("dinov2 N1601 16x64", 1601, 16, None), ("decoder N1600 8x128", 1600, 8, None),
          ("dinov2 N1664 n_valid 1601", 1664, 16, 1601)),
    "B": (("coarse s16 40^2 C512 r7", 40, 512, 7), ("coarse s8 70^2 C512 r3", 70, 512, 3),
          ("coarse s4 140^2 C256 r2", 140, 256, 2), ("upsample s8 108^2 C512 r3", 108, 512, 3),
          ("upsample s4 216^2 C256 r2", 216, 256, 2)),
    "C": (("coarse s16 40^2 C512", 40, 512), ("coarse s8 70^2 C512", 70, 512), ("coarse s4 140^2 C256", 140, 256),
          ("coarse s2 280^2 C64", 280, 64), ("coarse s1 560^2 C9", 560, 9), ("upsample s8 108^2 C512", 108, 512),
          ("upsample s4 216^2 C256", 216, 256), ("upsample s2 432^2 C64", 432, 64),
          ("upsample s1 864^2 C9", 864, 9)),
    "D": (("coarse s1 560^2 C24 x9", 560), ("upsample s1 864^2 C24 x9", 864)),
    "N": (("coarse s16 35^2 C1377", 35, 1377), ("coarse s8 70^2 C1137", 70, 1137), ("coarse s4 140^2 C569", 140, 569),
          ("coarse s2 280^2 C144", 280, 144), ("upsample s8 108^2 C1137", 108, 1137),
          ("upsample s4 216^2 C569", 216, 569), ("upsample s2 432^2 C144", 432, 144)),
}
# Mega-1500's 672 -> 1344 in MatchEngine at batch 4 (B = 8 images): DINOv2 at
# 48^2 + 1 tokens, the decoder at 48^2, every map of both passes
MEGA_SHAPES = {
    "batch": 8,
    "A": (("dinov2 N2305 16x64", 2305, 16, None), ("decoder N2304 8x128", 2304, 8, None)),
    "B": (("coarse s16 48^2 C512 r7", 48, 512, 7), ("coarse s8 84^2 C512 r3", 84, 512, 3),
          ("coarse s4 168^2 C256 r2", 168, 256, 2), ("upsample s8 168^2 C512 r3", 168, 512, 3),
          ("upsample s4 336^2 C256 r2", 336, 256, 2)),
    "C": (("coarse s16 48^2 C512", 48, 512), ("coarse s8 84^2 C512", 84, 512), ("coarse s4 168^2 C256", 168, 256),
          ("coarse s2 336^2 C64", 336, 64), ("coarse s1 672^2 C9", 672, 9), ("upsample s8 168^2 C512", 168, 512),
          ("upsample s4 336^2 C256", 336, 256), ("upsample s2 672^2 C64", 672, 64),
          ("upsample s1 1344^2 C9", 1344, 9)),
    "D": (("coarse s1 672^2 C24 x9", 672), ("upsample s1 1344^2 C24 x9", 1344)),
    "N": (("coarse s16 42^2 C1377", 42, 1377), ("coarse s8 84^2 C1137", 84, 1137), ("coarse s4 168^2 C569", 168, 569),
          ("coarse s2 336^2 C144", 336, 144), ("upsample s8 168^2 C1137", 168, 1137),
          ("upsample s4 336^2 C569", 336, 569), ("upsample s2 672^2 C144", 672, 144)),
}


def kernel_cases(gen, dt, shapes=MATCH_SHAPES):
    """The Cases of Kernels A-D and N at ``shapes`` (the main path's by default),
    inputs of dtype ``dt`` made on the card from ``gen``."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.tools.bench_hcw_refiner import make_modules, model_stack

    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    es = torch.finfo(dt).bits // 8
    nb = shapes["batch"]
    out = []
    # Kernel A: DINOv2 (16 x 64) and TransformerDecoder (8 x 128), and on
    # the main path the n_valid key mask on a padded sequence
    for label, n, heads, nv in shapes["A"]:
        qkv = attn_qkv(rn, nb, n, 1024, nv)
        q, k, v = qkv.view(nb, n, 3, heads, 1024 // heads).permute(2, 0, 3, 1, 4)
        out.append(Case("fused_attention_packed", label,
                        lambda q=qkv, h=heads, v=nv: ops.fused_attention_packed(q, h, v),
                        lambda q=qkv, h=heads, v=nv: ops.attention_packed_reference(q, h, v),
                        rows=nv or n, bytes=nb * n * 4 * 1024 * es, ops=4 * nb * n * (nv or n) * 1024,
                        peak=PEAK_BF16_TENSOR, library=sdpa_library(q, k, v, nv)))
    # Kernel B: every local-correlation scale of both passes; its dot
    # products take f1's dtype (the TPU kernel's MXU operands), the bilinear
    # fold of the (2r + 2)^2 integer taps is f32
    for label, hw, c, r in shapes["B"]:
        f0, f1, w = rn(nb, hw, hw, c), rn(nb, hw, hw, c), smooth_flow(gen, nb, hw, hw)
        npx = nb * hw * hw
        out.append(Case("local_correlation", label,
                        lambda a=f0, b=f1, r=r, w=w: ops.local_correlation(a, b, r, w),
                        lambda a=f0, b=f1, r=r, w=w: ops.local_correlation_reference(a, b, r, w),
                        bytes=npx * (2 * c * es + 8 + (2 * r + 1) ** 2 * es),
                        ops=npx * 2 * c * (2 * r + 2) ** 2, f32_ops=npx * 8 * (2 * r + 1) ** 2,
                        peak=PEAK_BF16_TENSOR if dt == torch.bfloat16 else PEAK_F32,
                        planted=lambda a=f0, b=f1, r=r, w=w: corr_fractions_swapped(a, b, r, w)))
    # Kernel C: the x_hat lookup at every scale of both passes
    for label, hw, c in shapes["C"]:
        y, w = rn(nb, hw, hw, c), smooth_flow(gen, nb, hw, hw)
        npx = nb * hw * hw
        out.append(Case("warp_sample", label,
                        lambda y=y, w=w: ops.warp_sample(y, w),
                        lambda y=y, w=w: ops.warp_sample_reference(y, w),
                        bytes=npx * (2 * c * es + 8), ops=8 * npx * c, library=grid_sample_library(y, w),
                        planted=lambda y=y, w=w: warp_fractions_swapped(y, w)))
    # Kernel D: the scale-1 refiner stack, 9 blocks of C = 24 folded from
    # eval-mode refiner_block modules, beside those modules' cuDNN stack as
    # the match runs a stack wider than 32 (bf16 modules, as under amp); the
    # pointwise product counts at the tensor cores' peak in bf16 (the
    # kernel's two bf16 products), the depthwise at the CUDA cores'
    mods = make_modules(24, gen, "cuda")
    with torch.no_grad():
        blocks = ops.fold_refiner(mods[0], mods[1:])
    for label, hw in shapes["D"]:
        x = rn(nb, hw, hw, 24)
        nbytes, pw_ops, dw_ops = refiner_cost(x, blocks)
        out.append(Case("fused_refiner_stack", label,
                        lambda x=x: ops.fused_refiner_stack(x, blocks),
                        lambda x=x: ops.refiner_stack_reference(x, blocks), bytes=nbytes, ops=pw_ops,
                        peak=PEAK_BF16_TENSOR if dt == torch.bfloat16 else PEAK_F32, f32_ops=dw_ops,
                        stack=(lambda x=x: model_stack(x, mods)) if dt == torch.bfloat16 else None,
                        planted=lambda x=x: refiner_edge_clamped(x, blocks)))
    # Kernel N: the depthwise half of one block of each wide stack, on the
    # stack's channels padded to C_ALIGN (zero), folded from an eval-mode
    # refiner_block, beside those modules' cuDNN depthwise, BatchNorm and
    # ReLU as the match ran them before (bf16 modules on the unpadded map)
    for label, hw, c in shapes["N"]:
        block = make_modules(c, gen, "cuda", n=1)[0]
        with torch.no_grad():
            p = ops.depthwise.padded_block(ops.fold_refiner(block, [])[0], ops.padded_width(c), dt)
        x = torch.nn.functional.pad(rn(nb, hw, hw, c), (0, ops.padded_width(c) - c))
        xs = x[..., :c].contiguous()
        out.append(Case("depthwise_bn_relu", label,
                        lambda x=x, p=p: ops.depthwise_bn_relu(x, p["dw"], p["db"]),
                        lambda x=x, p=p: ops.depthwise_bn_relu_reference(x, p["dw"], p["db"]),
                        bytes=2 * x.numel() * es + 4 * p["dw"].numel() + 4 * p["db"].numel(),
                        f32_ops=2 * KSIZE_N**2 * x.numel(),
                        stack=(lambda xs=xs, m=block[:3]: model_stack(xs, [m])) if dt == torch.bfloat16 else None,
                        planted=lambda x=x, p=p: depthwise_tap_dropped(x, p["dw"], p["db"])))
    return out


def check_output(name, label, dt, k, p, what: str = "") -> float:
    """Hold one kernel output to its plain version with the tolerances
    above (the kernels of ULP_BARS to their bf16 ulp bar too); print the
    comparison and return the error."""
    import torch

    if k.is_cuda:
        torch.cuda.synchronize()
    k, p = k.float(), p.float()
    require(k.shape == p.shape, f"{name} {label}: shape {tuple(k.shape)} vs {tuple(p.shape)}")
    require(bool(torch.isfinite(k).all()), f"{name} {label}: non-finite kernel output")
    err, scale = (k - p).abs().max().item(), p.abs().max().item()
    tol = F32_REL * max(1.0, scale) if dt == torch.float32 else BF16_REL * scale + BF16_ABS
    ulps = ""
    if dt == torch.bfloat16 and name in ULP_BARS:
        tol = min(tol, ULP_BARS[name] * bf16_ulp(scale))
        ulps = f", {err / bf16_ulp(scale):.2f} ulp" if scale > 0 else ""
    print(f"{name:24s} {label:30s} {str(dt)[6:]:8s} {what}max|k-p| {err:.3e}{ulps} "
          f"(tol {tol:.3e}, max|p| {scale:.3g})", flush=True)
    require(err <= tol, f"{name} {label} {dt} {what}: kernel disagrees with its plain version")
    return err


def check_power(name, label, what, ref, wrong, fault: str = "softmax scale x1.02", f32: bool = False,
                exact: bool = False):
    """A bar must be able to fail its kernel: the plain version with one
    planted fault (``wrong``: for attention the softmax scale off by 2%,
    else FAULTS[name]) must move by more than the bar check_output holds
    the kernel to: in bf16 ULP_BARS[name] ulps of the largest reference
    value; with ``f32``, F32_REL of it (at least F32_REL); with ``exact``
    (Kernel F's integer slots), at least one element."""
    if exact:
        moved = int((wrong != ref).sum())
        print(f"{name:24s} {label:30s} int32    {what}{fault} changes {moved} of {ref.numel()} slots of the "
              f"plain version (exact check)", flush=True)
        require(moved > 0, f"{name} {label} {what}: the exact check would pass a planted fault ({fault})")
        return
    moved = (wrong.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if f32:
        bar = F32_REL * max(1.0, scale)
        print(f"{name:24s} {label:30s} float32  {what}{fault} moves the plain version "
              f"{moved:.3e} ({moved / bar:.1f} x the f32 bar {bar:.3e})", flush=True)
    else:
        n = ULP_BARS[name]
        bar = n * bf16_ulp(scale)
        print(f"{name:24s} {label:30s} bf16     {what}{fault} moves the plain version "
              f"{moved:.3e} ({moved / bar * n:.1f} ulp, bar {n})", flush=True)
    require(moved > bar, f"{name} {label} {what}: the bar would pass a planted fault ({fault})")


def record(r, err, case: Case, dtype: str = "bf16"):
    """Add a case's CUDA-event medians (kernel, plain version, library call:
    call times), the kernel's and the library call's device times, its
    bound and its error to a kernel's row; the timed cases are the bf16
    ones (Kernel F's: bool flags in, int32 slots out)."""
    ms, pms = cuda_ms(case.kern), cuda_ms(case.plain)
    dms, how = device_ms(case.kern, ms)
    lms = cuda_ms(case.library) if case.library else None
    ldms, lhow = device_ms(case.library, lms, case.library_graph) if case.library else (None, None)
    bytes_ms, ops_ms = 1e3 * case.bytes / HBM_BYTES_PER_S, case.ops_ms()
    r["ms"] += ms
    r["device_ms"] += dms
    r["plain_ms"] += pms
    r["bound_ms"] += max(bytes_ms, ops_ms)
    r["_bytes_ms"] += bytes_ms
    r["_ops_ms"] += ops_ms
    r["_methods"] |= {how, lhow} - {None}
    if lms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + lms
        r["library_device_ms"] = (r["library_device_ms"] or 0.0) + ldms
    r["max_abs_err"] = max(r["max_abs_err"], err)
    lib = f"  library {lms:.4f} ms (device {ldms:.4f}, {lhow})" if lms is not None else ""
    if case.stack:
        sms = cuda_ms(case.stack)
        sdms, _ = device_ms(case.stack, sms)
        r["stack_ms"] = r.get("stack_ms", 0.0) + sms
        r["stack_device_ms"] = r.get("stack_device_ms", 0.0) + sdms
        lib += f"  cuDNN stack {sms:.4f} ms (device {sdms:.4f}, graph)"
    rate = ""
    if case.name in ATTENTION_KERNELS:  # achieved rate at the bound's operations
        rate = f"  {case.ops / dms / 1e9:.1f} TFLOP/s" + (f" (library {case.ops / ldms / 1e9:.1f})" if ldms else "")
    print(f"{r['name']:26s} {case.label:30s} {dtype:8s} kernel {ms:.4f} ms (device {dms:.4f}, {how}; host "
          f"{ms - dms:.4f})  plain {pms:.4f} ms{lib}  bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}){rate}", flush=True)
    return ms, pms


def check_kernels(results, shapes=MATCH_SHAPES):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for case in kernel_cases(gen, dt, shapes):
            rows = case.rows
            ref = case.plain()[:, :rows]
            check = check_bits if case.name in BITWISE else check_output
            err = check(case.name, case.label, dt, case.kern()[:, :rows], ref)
            if dt == torch.bfloat16:
                if case.planted:
                    check_power(case.name, case.label, "", ref, case.planted(), FAULTS[case.name])
                record(results[case.name], err, case)
            del ref
        torch.cuda.empty_cache()


# Kernels D and B off the main path's shapes, (B, H, W, C, K) and
# (B, H, W, C, r): D's generic instantiation (C, K other than 24, 5) and the
# 24, 5 one on ragged tiles; B's scalar path (a row not a whole number of
# 16-byte vectors), its vector paths with idle lanes (C = 16, 64) and every
# radius the models use
D_EDGES = ((1, 37, 45, 24, 5), (2, 19, 70, 16, 3), (1, 33, 31, 32, 7), (1, 8, 9, 5, 1))
B_EDGES = ((1, 23, 29, 256, 0), (1, 17, 21, 512, 7), (2, 20, 24, 64, 3), (1, 15, 33, 16, 2),
           (1, 19, 17, 20, 1), (2, 12, 40, 256, 2))
# Kernel C off the main path's widths, C -> the path it takes in f32 and
# bf16, on a 37 x 45 map sampled at a 29 x 53 query grid
C_EDGES = {3: "registers", 5: "registers", 16: "vector", 24: "vector", 37: "scalar"}


def far_flow(gen, b, h, w):
    """smooth_flow with a third of the queries thrown far off the image
    (|x| up to ~1e4) and a row on each border of [-1, 1]."""
    import torch

    f = smooth_flow(gen, b, h, w)
    far = torch.rand(b, h, w, 1, generator=gen, device="cuda") < 0.33
    f = torch.where(far, 3e3 * torch.randn(b, h, w, 2, generator=gen, device="cuda"), f)
    f[:, 0, :, 1], f[:, -1, :, 1] = -1.0, 1.0
    return f.contiguous()


def check_match_edges():
    """Kernels D and B at D_EDGES and B_EDGES against their plain versions
    (B under a smooth warp with an off-image band and under a wild one), f32
    and bf16; Kernel C at C_EDGES bitwise, under a smooth flow and a far
    one, each width's path asserted; and their vector paths refusing a base
    off 16 bytes (C's registers path one off a pair of elements)."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops.warp_sample import warp_sample_checks

    gen = torch.Generator(device="cuda").manual_seed(10)
    for dt in (torch.float32, torch.bfloat16):
        rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
        for b, h, w, c, k in D_EDGES:
            blocks, x = refiner_blocks(gen, c, 3, k), rn(b, h, w, c)
            check_output("fused_refiner_stack", f"edge {b}x{h}x{w} C{c} K{k} x3", dt,
                         ops.fused_refiner_stack(x, blocks), ops.refiner_stack_reference(x, blocks))
        for b, h, w, c, r in B_EDGES:
            f0, f1 = rn(b, h, w, c), rn(b, h, w, c)
            for kind, flow in (("smooth", smooth_flow(gen, b, h, w)),
                               ("wild", 2.5 * torch.randn(b, h, w, 2, generator=gen, device="cuda"))):
                check_output("local_correlation", f"edge {b}x{h}x{w} C{c} r{r} {kind}", dt,
                             ops.local_correlation(f0, f1, r, flow), ops.local_correlation_reference(f0, f1, r, flow))
        for c, want in C_EDGES.items():
            y = rn(2, 37, 45, c)
            path = warp_sample_checks("warp_sample", y, smooth_flow(gen, 2, 29, 53))[-1]
            require(path == want, f"warp_sample C{c} {dt}: path {path}, not {want}")
            for kind, flow in (("smooth", smooth_flow(gen, 2, 29, 53)), ("far", far_flow(gen, 2, 29, 53))):
                check_bits("warp_sample", f"edge 2x37x45 C{c} q29x53 {kind} {path}", dt, ops.warp_sample(y, flow),
                           ops.warp_sample_reference(y, flow))
    flat = torch.zeros(2 * 16 * 16 * 256 + 8, dtype=torch.bfloat16, device="cuda")
    off = flat[1:1 + 16 * 16 * 256].view(1, 16, 16, 256)
    fine = torch.zeros(1, 16, 16, 256, dtype=torch.bfloat16, device="cuda")
    xoff = flat[1:1 + 16 * 16 * 24].view(1, 16, 16, 24)
    yoff = flat[1:1 + 16 * 16 * 9].view(1, 16, 16, 9)
    grid = torch.zeros(1, 16, 16, 2, device="cuda")
    for what, call in (("fused_refiner_stack, x base + 2 bytes",
                        lambda: ops.fused_refiner_stack(xoff, refiner_blocks(gen, 24, 1))),
                       ("local_correlation, f1 base + 2 bytes", lambda: ops.local_correlation(fine, off, 2, grid)),
                       ("warp_sample C256 (vector), y base + 2 bytes", lambda: ops.warp_sample(off, grid)),
                       ("warp_sample C9 (registers), y base + 2 bytes", lambda: ops.warp_sample(yoff, grid))):
        try:
            call()
        except ValueError as e:
            print(f"misaligned view refused: {what}: {e}", flush=True)
        else:
            raise SmokeFailure(f"misaligned view accepted: {what}")


# the attention shapes of the training step and the match: the decoder's,
# DINOv2's, and a padded sequence with the n_valid key mask
ATTN_SHAPES = (("decoder N1600 8x128", 4, 1600, 8, 128, None),
               ("dinov2 N1601 16x64", 8, 1601, 16, 64, None),
               ("dinov2 N1664 n_valid 1601", 8, 1664, 16, 64, 1601))


def check_attention_kernels(results):
    """Kernel E against its plain backward on the packed layout the training
    step hands it (dq, dk, dv reported apart), and Kernel A's per-head entry
    against the einsum sdpa, at ATTN_SHAPES in both dtypes."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops.fused_attention import _heads, _packed_forward, _qkv_heads

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
        es = torch.finfo(dt).bits // 8
        for label, b, n, h, d, nv in ATTN_SHAPES:
            c = h * d
            qkv = attn_qkv(rn, b, n, c, nv)
            out, lse = _packed_forward(qkv, h, nv, with_lse=True)
            dout = rn(b, n, c)
            dqkv = torch.empty_like(qkv)
            q, k, v = _qkv_heads(qkv, h)
            grads = _qkv_heads(dqkv, h)
            kern = lambda: ops.fused_attention_backward(q, k, v, _heads(out, h), lse, _heads(dout, h),
                                                        *grads, n_valid=nv)
            plain = lambda: ops.attention_backward_reference(q, k, v, _heads(dout, h), nv)
            kern()
            refs = plain()
            errs = [check_output("fused_attention_backward", label, dt, got, ref, f"{gname} ")
                    for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs)]
            if dt == torch.bfloat16:
                wrongs = ops.attention_backward_reference((1.02 * q.float()).to(dt), k, v, _heads(dout, h), nv)
                for gname, ref, wrong in zip(("dq", "dk", "dv"), refs, wrongs):
                    check_power("fused_attention_backward", label, f"{gname} ", ref, wrong)
                del wrongs
            del refs
            if dt == torch.bfloat16:
                # the library's backward on contiguous leaves; its forward runs
                # once here, outside the timed window
                leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
                lout = sdpa_library(*leaves, nv)()
                dh = _heads(dout, h).contiguous()
                record(results["fused_attention_backward"], max(errs),
                       Case("fused_attention_backward", label, kern, plain,
                            bytes=8 * b * n * c * es + 4 * b * h * n, ops=10 * b * n * (nv or n) * c,
                            peak=PEAK_BF16_TENSOR, library_graph=False,
                            library=lambda: torch.autograd.grad(lout, leaves, dh, retain_graph=True)))
                del leaves, lout, dh

            qh, kh, vh = attn_heads(rn, b, h, n, d, nv)
            kern = lambda: ops.fused_attention(qh, kh, vh, nv)
            plain = lambda: ops.sdpa_reference(qh, kh, vh, nv)
            rows = nv or n
            ref = plain()[:, :, :rows]
            err = check_output("fused_attention", label, dt, kern()[:, :, :rows], ref)
            if dt == torch.bfloat16:
                check_power("fused_attention", label, "", ref,
                            ops.sdpa_reference((1.02 * qh.float()).to(dt), kh, vh, nv)[:, :, :rows])
                record(results["fused_attention"], err,
                       Case("fused_attention", label, kern, plain, bytes=4 * b * n * c * es,
                            ops=4 * b * n * (nv or n) * c, peak=PEAK_BF16_TENSOR,
                            library=sdpa_library(qh, kh, vh, nv)))
            del qkv, out, lse, dout, dqkv, ref
            torch.cuda.empty_cache()


# bf16 attention at its edges, (B, H, N, D, n_valid): one key and one query;
# one partial tile; a ragged N at D = 128 with n_valid short of it; a second
# key tile holding one valid key
RAGGED = ((1, 1, 1, 64, 1), (1, 2, 17, 64, 17), (2, 3, 65, 128, 63), (1, 2, 130, 64, 129))


def check_tc_build(log: str):
    """Registers and spills of the bf16 tensor-core attention kernels from
    the build's -Xptxas -v report; a spill fails."""
    import re

    props, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            props.setdefault(cur, {})["spills"] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            props.setdefault(cur, {})["regs"] = int(m[1])
    tc = {}
    for name, p in props.items():
        m = re.search(r"(attn_\w+?_tc_kernel)ILi(\d+)E", name)
        if m:
            tc[f"{m[1]}<D={m[2]}>"] = p
    require(len(tc) == 6, f"ptxas: expected 6 bf16 attention kernels, found {sorted(tc)}")
    for name, p in sorted(tc.items()):
        print(f"ptxas {name:32s} {p.get('regs')} registers, spill stores / loads {p.get('spills')} bytes",
              flush=True)
    spilled = [name for name, p in tc.items() if p.get("spills") != (0, 0)]
    require(not spilled, f"ptxas: registers spill in {spilled}")


def check_attention_edges():
    """Kernels A and E in bf16 at RAGGED shapes (per-head) and on a packed
    view against their plain versions, every row compared; E twice at the
    full-width decoder shape, bitwise; misaligned bf16 views refused."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops.fused_attention import _head_forward, _heads, _packed_forward, _qkv_heads

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(8)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)

    def backward(label, views, out, lse, dout, grads, nv):
        ops.fused_attention_backward(*views, out, lse, dout, *grads, n_valid=nv)
        refs = ops.attention_backward_reference(*views, dout, nv)
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            check_output("fused_attention_backward", label, dt, got, ref, f"{gname} ")

    for b, h, n, d, nv in RAGGED:
        label = f"ragged {b}x{h}x{n}x{d} nv{nv}"
        q, k, v = attn_heads(rn, b, h, n, d, nv)
        out, lse = _head_forward(q, k, v, nv, with_lse=True)
        check_output("fused_attention", label, dt, out, ops.sdpa_reference(q, k, v, nv))
        backward(label, (q, k, v), out, lse, rn(b, h, n, d), [torch.empty_like(q) for _ in range(3)], nv)

    label, n, heads, nv = "ragged packed 1x130 2x64 nv129", 130, 2, 129
    qkv = attn_qkv(rn, 1, n, 128, nv)
    out, lse = _packed_forward(qkv, heads, nv, with_lse=True)
    check_output("fused_attention_packed", label, dt, out, ops.attention_packed_reference(qkv, heads, nv))
    dqkv = torch.empty_like(qkv)
    backward(label, _qkv_heads(qkv, heads), _heads(out, heads), lse, _heads(rn(1, n, 128), heads),
             _qkv_heads(dqkv, heads), nv)

    # no atomics: two runs at the decoder's full width give the same bits
    qkv = attn_qkv(rn, 4, 1600, 1024)
    out, lse = _packed_forward(qkv, 8, None, with_lse=True)
    dout = rn(4, 1600, 1024)
    runs = []
    for _ in range(2):
        dqkv = torch.empty_like(qkv)
        ops.fused_attention_backward(*_qkv_heads(qkv, 8), _heads(out, 8), lse, _heads(dout, 8),
                                     *_qkv_heads(dqkv, 8))
        runs.append(dqkv.view(torch.int16))
    torch.cuda.synchronize()
    require(torch.equal(runs[0], runs[1]), "fused_attention_backward: two runs differ")
    print(f"{'fused_attention_backward':24s} {'decoder N1600 8x128, twice':30s} bf16     bitwise equal", flush=True)
    del qkv, out, lse, dout, runs, dqkv

    # a bf16 view whose base is one element off 16 bytes is refused before
    # any launch, in each entry
    flat = torch.zeros(64 * 3 * 128 + 1, dtype=dt, device="cuda")
    off, packed = flat[1:2 * 64 * 64 + 1].view(1, 2, 64, 64), flat[1:].view(1, 64, 3 * 128)
    fine = torch.zeros(1, 2, 64, 64, dtype=dt, device="cuda")
    lse = torch.zeros(1, 2, 64, device="cuda")
    for what, call in (("fused_attention, q base + 2 bytes", lambda: ops.fused_attention(off, off, off)),
                       ("fused_attention_packed, qkv base + 2 bytes", lambda: ops.fused_attention_packed(packed, 2)),
                       ("fused_attention_backward, dq base + 2 bytes",
                        lambda: ops.fused_attention_backward(fine, fine, fine, fine, lse, fine, off,
                                                             torch.empty_like(fine), torch.empty_like(fine)))):
        try:
            call()
        except ValueError as e:
            print(f"misaligned bf16 view refused: {what}: {e}", flush=True)
        else:
            raise SmokeFailure(f"misaligned bf16 view accepted: {what}")


def check_zoo(model, pair, warp, cert, d: str) -> tuple[str, str]:
    """The zoo phase: the released models' entry points from local files.
    Writes ``model``'s weights as a reference-layout pair (the roma state
    dict and the DINOv2 one, float32, as the released .pth files) to the
    directory ``d``, builds roma_outdoor and roma_indoor from those
    paths on the card, requires every loaded tensor to equal the file's and
    the 560 -> 864 match of ``pair`` to equal ``warp`` and ``cert`` (the
    seeded model's) to the bf16 bar, then runs match_keypoints,
    conf_from_fb_consistency and visualize_warp on roma_outdoor's output.
    Prints each model's load time and the peak device memory of its load and
    match with the card's line. Returns the pair's paths."""
    import torch

    from roma_tpu_torch.models import roma_indoor, roma_outdoor
    from roma_tpu_torch.models.zoo import convert

    roma_sd, dino_sd = convert.to_reference(model.net)
    files = {**roma_sd, **{convert.DINO_PREFIX + k: v for k, v in dino_sd.items()}}
    paths = os.path.join(d, "roma_outdoor.pth"), os.path.join(d, "dinov2_vitl14_pretrain.pth")
    t0 = time.perf_counter()
    torch.save(roma_sd, paths[0])
    torch.save(dino_sd, paths[1])
    print(f"zoo: reference-layout pair of {len(roma_sd)} + {len(dino_sd)} float32 tensors "
          f"({sum(map(os.path.getsize, paths))} bytes) written in {time.perf_counter() - t0:.2f} s", flush=True)
    del roma_sd, dino_sd
    for name, build in (("roma_outdoor", roma_outdoor), ("roma_indoor", roma_indoor)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = build(*paths, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = m.net.state_dict()
        for k, v in files.items():
            require(torch.equal(loaded[k].float(), v.to("cuda")), f"zoo {name}: {k} is not the file's")
        got_warp, got_cert = m.match(*pair)
        check_output(name, "560->864 vs the seeded model", torch.bfloat16, got_warp, warp, "warp ")
        check_output(name, "560->864 vs the seeded model", torch.bfloat16, got_cert, cert, "certainty ")
        if name == "roma_outdoor":
            check_match_api(m, pair, got_warp, got_cert, d)
        torch.cuda.synchronize()
        print(f"zoo {name}: built from the files in {load_s:.2f} s, {len(files)} tensors equal to the files'; "
              f"peak device memory of the load and match {torch.cuda.max_memory_allocated()} bytes; card "
              f"{smi_line()}", flush=True)
        del m, loaded
        torch.cuda.empty_cache()
    return paths


def check_match_api(m, pair, warp, cert, out_dir):
    """match_keypoints on 5000 matches sampled from the warp,
    conf_from_fb_consistency on its two halves and visualize_warp of the
    pair, on the card: shapes, ranges and finiteness."""
    import numpy as np
    import torch

    h, w = warp.shape[0], warp.shape[1] // 2
    matches, _ = m.sample(warp, cert, num=5000, key=0)
    k_a, k_b = m.match_keypoints(matches[:, :2], matches[:, 2:], warp, cert)
    inds_a, inds_b = m.match_keypoints(matches[:, :2], matches[:, 2:], warp, cert, return_inds=True)
    require(isinstance(k_a, np.ndarray) and k_a.shape == k_b.shape == (len(inds_a), 2)
            and len(inds_a) == len(inds_b) and np.isfinite(k_a).all() and np.isfinite(k_b).all()
            and (inds_a < 5000).all() and (inds_b < 5000).all(), "match_keypoints: bad output")
    conf = m.conf_from_fb_consistency(warp[:, :w, 2:], warp[:, w:, :2])
    require(conf.is_cuda and tuple(conf.shape) == (h, w) and bool(((conf == 0) | (conf == 1)).all()),
            "conf_from_fb_consistency: bad output")
    vis = m.visualize_warp(warp, cert, *pair, save_path=os.path.join(out_dir, "warp.png"))
    require(vis.is_cuda and tuple(vis.shape) == (h, 2 * w, 3) and bool(torch.isfinite(vis).all())
            and os.path.getsize(os.path.join(out_dir, "warp.png")) > 0, "visualize_warp: bad output")
    print(f"zoo roma_outdoor: match_keypoints {len(inds_a)} mutual pairs of 5000 samples, "
          f"conf_from_fb_consistency {conf.mean().item():.4f} consistent, visualize_warp {tuple(vis.shape)} "
          f"in [{vis.min().item():.3f}, {vis.max().item():.3f}]", flush=True)


SERVE_PAIRS, SERVE_BATCH, SERVE_TIMED_BATCH, SERVE_TIMED_PAIRS = 9, 4, 8, 24


def check_serving(model, batch1_pairs_per_s: float):
    """The serve phase: MatchEngine over the phase-4 model. 9 synthetic
    720x960 pairs written as PNG files and a 10th whose A image is corrupt,
    at batch 4 with on_error="skip": 10 results in input order, the 10th
    carrying the error, 3 batches of 4 rows (the last padded: one pair
    survives there), every row of every batch's input bitwise the
    preprocessing model.match gives that pair's files, and Kernels A, B, C
    and D launched in every batch. Then each result against model.match of
    its pair (batch 1) to the bf16 bar, with the coarse classifier pinned by
    one peaked gm_logit_bias on both sides: on random weights its 4096-way
    argmax is a near-tie that bf16 at batch 4 and at batch 1 (other cuDNN
    algorithms) break differently on a few percent of the pixels, which the
    unpinned run prints. Then batch 8 over 24 pairs, timed after one warm-up
    batch: pairs/s (match only) beside phase 4's batch-1 rate (match +
    sample), the host prep of one batch of 8 timed alone, and the peak
    device memory."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from roma_tpu_torch.experiments.validate_release import peaked_bias
    from roma_tpu_torch.serving import WORKERS, MatchEngine
    from roma_tpu_torch.utils.image import load_image

    t_phase = time.perf_counter()
    grid, res = model.h_resized // 14, model.net.config.cls_res
    field = peaked_bias(2, grid, grid, res)  # one A->B and one B->A field for every pair

    def pinned(b):  # the symmetric batch is [A_i -> B_i ..., B_i -> A_i ...]
        return np.concatenate([np.repeat(field[:1], b, 0), np.repeat(field[1:], b, 0)])

    with tempfile.TemporaryDirectory() as d:
        pairs = []
        for k in range(SERVE_PAIRS):
            pair = []
            for im, side in zip(synthetic_pair(100 + k), "ab"):
                pair.append(os.path.join(d, f"{side}{k}.png"))
                im.save(pair[-1])
            pairs.append(tuple(pair))
        corrupt = os.path.join(d, "corrupt.png")
        with open(corrupt, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n not a png")
        pairs.append((corrupt, pairs[0][1]))

        calls, pin = [], False
        match = model.match

        def counted(*a, **kw):  # each batch's inputs and launches
            zero_counts()
            out = match(*a, gm_logit_bias=pinned(a[0].shape[0]) if pin else None, **kw)
            calls.append((a, kw, read_counts()))
            return out

        model.match = counted
        try:
            results = list(MatchEngine(model, batch_size=SERVE_BATCH).match_paths(pairs, on_error="skip"))
            batches, calls, pin = calls, [], True
            pinned_results = list(MatchEngine(model, batch_size=SERVE_BATCH).match_paths(pairs, on_error="skip"))
        finally:
            del model.match
        require([r.index for r in results] == list(range(len(pairs))), "serve: results out of order")
        failed = [r.index for r in results if r.error is not None]
        require(failed == [len(pairs) - 1] and results[-1].warp is None, f"serve: failed pairs {failed}")
        rows = [(list(r) + [r[-1]] * SERVE_BATCH)[:SERVE_BATCH] for r in ((0, 1, 2, 3), (4, 5, 6, 7), (8,))]
        require(len(batches) == len(rows), f"serve: {len(batches)} batches")
        for (a, kw, counts), ks in zip(batches, rows):
            missing = [n for n in MATCH_KERNELS if counts[n] == 0]
            require(not missing, f"serve: a batch launched no {missing}")
            for j, k in enumerate(ks):
                pil = [load_image(p) for p in pairs[k]]
                for got, hw in (((a[0], a[1]), (model.h_resized, model.w_resized)),
                                ((kw["im_A_high_res"], kw["im_B_high_res"]), model.upsample_res)):
                    want = model._prep_pair(*pil, [hw])[0]
                    require(all(torch.equal(g[j], w[0]) for g, w in zip(got, want)),
                            f"serve: batch row {j} (pair {k}) is not match()'s preprocessing of its files")
        print(f"serve: batch {SERVE_BATCH}, {len(pairs)} pairs (one corrupt), {len(batches)} batches of "
              f"{SERVE_BATCH} rows (pairs {rows}), every row match()'s preprocessing bit for bit; launches a batch "
              + "; ".join(", ".join(f"{n} {c[n]}" for n in MATCH_KERNELS) for _, _, c in batches), flush=True)
        tol = BF16_REL + BF16_ABS  # the bf16 bar at max|p| = 1
        for r, rp in zip(results[:-1], pinned_results[:-1]):
            warp, _ = model.match(r.im_A, r.im_B)
            off = ((r.warp - warp).abs().amax(-1) > tol).float().mean().item()
            print(f"serve pair {r.index}: unpinned, batch 4 vs batch 1, warp off the bf16 bar on {off:.5f} "
                  "of the pixels", flush=True)
            warp, cert = model.match(r.im_A, r.im_B, gm_logit_bias=pinned(1))
            check_output("serve", f"pair {r.index} vs match, pinned", torch.bfloat16, rp.warp, warp, "warp ")
            check_output("serve", f"pair {r.index} vs match, pinned", torch.bfloat16, rp.certainty, cert, "certainty ")

        stream = [pairs[k % SERVE_PAIRS] for k in range(SERVE_TIMED_PAIRS)]
        engine = MatchEngine(model, batch_size=SERVE_TIMED_BATCH)
        list(engine.match_paths(stream[:SERVE_TIMED_BATCH]))  # warm-up: cuDNN picks batch 8's algorithms
        with ThreadPoolExecutor(WORKERS) as pool:
            t0 = time.perf_counter()
            engine._prep_batch(pool, [(k, a, b) for k, (a, b) in enumerate(stream[:SERVE_TIMED_BATCH])])
            prep_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        timed = list(engine.match_paths(stream))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(len(timed) == SERVE_TIMED_PAIRS and all(r.error is None for r in timed), "serve: timed run failed")
    print(f"serve: batch {SERVE_TIMED_BATCH}, {SERVE_TIMED_PAIRS} pairs in {wall:.4f} s = "
          f"{SERVE_TIMED_PAIRS / wall:.4f} pairs/s (match only; phase 4, batch 1, match + sample: "
          f"{batch1_pairs_per_s:.4f} pairs/s); host prep of one batch of {SERVE_TIMED_BATCH} alone {prep_s:.4f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes; card {smi_line()}", flush=True)
    print(f"serve phase: {time.perf_counter() - t_phase:.2f} s", flush=True)


# Mega-1500's 672 -> 1344 through MatchEngine at batch 4, over pairs of
# MegaDepth's undistorted image sizes (long side 1600) written as JPEG at
# quality 95. A batch launches A in DINOv2's 24 blocks and the decoder's 5,
# B at the 5 scales with a local correlation, C at all 9 scales of both
# passes, D once a block of the two scale-1 stacks (9 blocks each), N once a
# block of the seven wide stacks (9 blocks each), and no other port kernel.
MEGA_RES, MEGA_BATCH, MEGA_BATCHES = (672, 1344), 4, 3
MEGA_SIZES = ((1066, 1600), (1200, 1600), (1600, 1066), (1600, 1200))
MEGA_LAUNCHES = {"fused_attention_packed": 29, "local_correlation": 5, "warp_sample": 9, "fused_refiner_stack": 18,
                 WIDE_KERNEL: WIDE_LAUNCHES}


def check_mega_engine(mega):
    """The 672 -> 1344 phase: roma_outdoor at Mega-1500's canvas (exact GELU,
    bf16 amp, symmetric) on seeded random weights, through
    MatchEngine(batch_size=4) over MEGA_BATCHES batches of MegaDepth-size
    JPEG pairs, after one warm-up batch (cuDNN picks its algorithms there).
    Every batch must launch MEGA_LAUNCHES and no other port kernel; every
    result is (1344, 2688) and finite, in input order. Prints the timed
    pairs/s and peak device memory; the launches of all batches go into
    ``mega``'s rows."""
    import torch

    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.serving import MatchEngine

    t_phase = time.perf_counter()
    model = roma_outdoor(device="cuda", seed=0, coarse_res=MEGA_RES[0], upsample_res=MEGA_RES[1],
                         vit_gelu_tanh=False)
    counts, match = [], model.match

    def counted(*a, **kw):  # each batch's launches
        zero_counts()
        out = match(*a, **kw)
        counts.append(read_counts())
        return out

    up = MEGA_RES[1]
    with tempfile.TemporaryDirectory() as d:
        pairs = []
        for k in range(MEGA_BATCH * MEGA_BATCHES):
            pair = []
            for im, side in zip(synthetic_pair(200 + k, MEGA_SIZES[k % len(MEGA_SIZES)]), "ab"):
                pair.append(os.path.join(d, f"{side}{k}.jpg"))
                im.save(pair[-1], quality=95)
            pairs.append(tuple(pair))
        model.match = counted
        try:
            engine = MatchEngine(model, batch_size=MEGA_BATCH)
            t0 = time.perf_counter()
            list(engine.match_paths(pairs[:MEGA_BATCH]))  # warm-up: cuDNN picks batch 4's algorithms
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results = list(engine.match_paths(pairs))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del model.match
    require([r.index for r in results] == list(range(len(pairs))), "672->1344: results out of order")
    for r in results:
        require(tuple(r.warp.shape) == (up, 2 * up, 4) and tuple(r.certainty.shape) == (up, 2 * up),
                f"672->1344: pair {r.index} warp {tuple(r.warp.shape)}, certainty {tuple(r.certainty.shape)}")
        require(bool(torch.isfinite(r.warp).all() and torch.isfinite(r.certainty).all()),
                f"672->1344: pair {r.index} non-finite")
    want = {n: MEGA_LAUNCHES.get(n, 0) for n in read_counts()}
    require(len(counts) == 1 + MEGA_BATCHES, f"672->1344: {len(counts)} batches, not 1 + {MEGA_BATCHES}")
    for i, c in enumerate(counts):
        require(c == want, f"672->1344: batch {i} launched {c}, not {want}")
    for name in MEGA_LAUNCHES:
        mega[name]["launches"] = sum(c[name] for c in counts)
    print(f"672->1344: MatchEngine batch {MEGA_BATCH}, warm-up batch {warm:.2f} s, then {len(pairs)} pairs of "
          f"{len(MEGA_SIZES)} MegaDepth sizes in {wall:.2f} s = {len(pairs) / wall:.4f} pairs/s; launches each of "
          f"the {len(counts)} batches " + ", ".join(f"{n} {k}" for n, k in MEGA_LAUNCHES.items())
          + f", no other; peak device memory {torch.cuda.max_memory_allocated()} bytes; card {smi_line()}", flush=True)
    del model, results
    torch.cuda.empty_cache()
    print(f"672->1344 phase: {time.perf_counter() - t_phase:.2f} s", flush=True)


# the f32 match error is held to EVAL_PX of JAX's: ~50x the measured 2e-5 px,
# under the 4e-3 - 5e-3 px that bf16 moves it; AUC to EVAL_PP on matched draws;
# the card's and the CPU generator's AUC@5 means over EVAL_SEEDS seeds to
# EVAL_SE standard errors; on identical uniforms, a sampling stage's draws on
# the card and on the CPU may differ in DRAW_DIFF of the draws (ties at the
# top-k boundary, last-ulp logs)
EVAL_GAIN, EVAL_PX, EVAL_PP, EVAL_SEEDS, EVAL_SE, DRAW_DIFF = 0.02, 1e-3, 0.5, 40, 3.0, 1e-3


def host_generator_matcher(results):
    """``PrecomputedMatcher`` whose draws come from a CPU generator seeded
    with the benchmark's key, computed on the warp's device."""
    import torch

    from roma_tpu_torch.ops import balanced_sample
    from roma_tpu_torch.tools import crossimpl as xi

    class HostGenerator(xi.PrecomputedMatcher):
        def sample(self, matches, certainty, num=5000, key=None):
            m, c = torch.as_tensor(matches).reshape(-1, 4), torch.as_tensor(certainty).reshape(-1)
            return balanced_sample(m, c, num, generator=torch.Generator().manual_seed(int(key)), thresh=0.05,
                                   mode="threshold_balanced")

    return HostGenerator(results)


def check_identical_uniforms(warp, cert, keys=(0, 1, 2)):
    """balanced_sample's stages on the card against the CPU on identical
    uniforms (CPU generators): the certainty draw (20000 of the warp's
    pixels), the KDE of one candidate set, and the inverse-density draw
    (5000 of those candidates) each agree but for DRAW_DIFF of the draws;
    the whole sample's agreement is printed (a swap of two tied candidates
    in the first stage hands them each other's second-stage uniforms)."""
    import torch

    from roma_tpu_torch.ops import balanced_sample, kde, multinomial_no_replacement
    from roma_tpu_torch.tools import crossimpl as xi

    gen = lambda k: torch.Generator().manual_seed(k)
    apart = lambda a, b: len(set(a.tolist()) ^ set(b.tolist())) / 2 / len(a)
    m_card, c_raw = warp.reshape(-1, 4), cert.reshape(-1).float()
    c_card = torch.where(c_raw > 0.05, torch.ones_like(c_raw), c_raw)
    m_cpu, c_cpu = m_card.cpu(), c_card.cpu()
    n = xi.SAMPLE_N
    for k in keys:
        i_card = multinomial_no_replacement(c_card, 4 * n, gen(k)).cpu()
        i_cpu = multinomial_no_replacement(c_cpu, 4 * n, gen(k))
        cand = m_cpu[i_cpu]
        den_cpu, den_card = kde(cand, std=0.1), kde(cand.cuda(), std=0.1)
        rel = ((den_card.cpu() - den_cpu).abs() / den_cpu).max().item()
        p = lambda d: torch.where(d < 10.0, torch.full_like(d, 1e-7), 1.0 / (d + 1.0))
        j_card = multinomial_no_replacement(p(den_card), n, gen(k + 1)).cpu()
        j_cpu = multinomial_no_replacement(p(den_cpu), n, gen(k + 1))
        rows = lambda x: {tuple(r) for r in x.cpu().tolist()}
        whole = len(rows(balanced_sample(m_card, c_raw, n, gen(k))[0]) & rows(balanced_sample(m_cpu, c_raw.cpu(), n,
                                                                                               gen(k))[0])) / n
        d1, d2 = apart(i_card, i_cpu), apart(j_card, j_cpu)
        print(f"eval draws on identical uniforms, key {k}: certainty draw apart {d1:.5f}, KDE max rel "
              f"{rel:.3e}, inverse-density draw apart {d2:.5f} (bar {DRAW_DIFF}); whole sample shared "
              f"{whole:.4f}", flush=True)
        require(d1 <= DRAW_DIFF and d2 <= DRAW_DIFF and rel <= 1e-4,
                f"eval: the card's draws on identical uniforms differ from the CPU's ({d1}, {d2}, {rel})")


def check_eval():
    """The eval phase: the capstone's 3 synthetic scenes at 560 -> 864 on
    the card (roma_tpu_torch.tools.crossimpl). capstone_net(0, 0.02) in
    float32 (TF32 off, as main sets it), each scene's bias solved from the
    card's own cls_logits; the warps through run_pose_benchmark with
    PrecomputedMatcher and the native RANSAC. Gates, float32: the match
    error's p50 and p95 within EVAL_PX px of the JAX values of
    CROSSIMPL_AUC_TORCH.json; AUC@5/10/20 within EVAL_PP pp of JAX's on
    matched draws (the warps copied to the host and sampled there with the
    CPU capstone's keys, as its comparison (a) does: an AUC of 15 pose
    estimates moves by ~0.5 pp between two sets of draws of one warp);
    balanced_sample on the card against the CPU on identical uniforms
    (check_identical_uniforms); and the AUC@5 drawn on the card against the
    AUC@5 drawn from CPU generators with the same keys, their means over
    benchmark seeds 0..EVAL_SEEDS-1 within EVAL_SE standard errors, both
    spreads printed. Then the same scenes and biases under the bf16 amp
    path: its card-drawn AUC within the file's amp bar (JAX's own
    bf16-vs-f32 delta + 0.5 pp) of the float32 one drawn with the same keys.
    Prints the native library's build time and the RANSAC time a repeat."""
    import numpy as np
    import torch

    from roma_tpu_torch import native
    from roma_tpu_torch.benchmarks.pose_bench import native_estimator, run_pose_benchmark
    from roma_tpu_torch.tools import crossimpl as xi

    t_phase = time.perf_counter()
    with open(os.path.join(HERE, "CROSSIMPL_AUC_TORCH.json")) as f:
        ref = json.load(f)["560to864"]["gains"][f"{EVAL_GAIN:g}"]
    t0 = time.perf_counter()
    native.load()
    print(f"eval: native RANSAC library built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({native.library_path().relative_to(HERE)})", flush=True)
    coarse, up, n = 560, 864, xi.N_SCENES
    pairs = xi.scene_pairs(n, up)
    keys = ("auc_5", "auc_10", "auc_20")
    fmt = lambda a: ", ".join(f"{k} {a[k]:.5f}" for k in keys)
    spread = lambda v: f"mean {np.mean(v):.5f} sd {np.std(v, ddof=1):.5f} min {min(v):.5f} max {max(v):.5f}"
    ransac_s = []

    def estimator(*args):
        t = time.perf_counter()
        try:
            return native_estimator(*args)
        finally:
            ransac_s.append(time.perf_counter() - t)

    def scores(matcher, seed=0):
        return run_pose_benchmark(matcher, pairs, estimator=estimator, repeats=xi.REPEATS, sample_n=xi.SAMPLE_N,
                                  seed=seed, progress=False, return_errors=True)

    biases, card_auc, errs = None, {}, {}
    for label, amp in (("f32", False), ("bf16", True)):
        net = xi.capstone_net(0, EVAL_GAIN, "cuda", amp=amp)
        m = xi.matcher(net, coarse, up)
        if biases is None:
            biases = [xi.scene_bias(net, i, coarse, up) for i in range(n)]
        res, per_scene = {}, []
        for i, bias in enumerate(biases):
            warp, cert = xi.match_scene(m, i, bias)
            require(bool(torch.isfinite(warp).all() and torch.isfinite(cert).all()), f"eval {label}: non-finite")
            res[xi.scene_tag(i)] = (warp, cert)
            per_scene.append(xi.match_error_px(warp, i, up))
        err = errs[label] = xi.error_percentiles(per_scene)
        ransac_s.clear()
        card_auc[label], card_err = scores(xi.PrecomputedMatcher(res))
        print(f"eval {label}: match error px p50 {err['p50']:.5f} p95 {err['p95']:.5f} max {err['max']:.4f}; "
              f"drawn on the card: {fmt(card_auc[label])}, pose errors deg {[round(e, 4) for e in card_err]}; "
              f"RANSAC {sum(ransac_s) / len(ransac_s):.4f} s a repeat; card {smi_line()}", flush=True)
        if label == "f32":
            jax_err, jax_auc = ref["match_err_px"]["jax_f32"], ref["auc"]["jax_f32"]
            for q in ("p50", "p95"):
                require(abs(err[q] - jax_err[q]) <= EVAL_PX,
                        f"eval: match error {q} {err[q]:.5f} px vs JAX {jax_err[q]:.5f} (bar {EVAL_PX})")
            host_auc, host_err = scores(xi.PrecomputedMatcher({k: (w.cpu(), c.cpu()) for k, (w, c) in res.items()}))
            d = {k: 100 * abs(host_auc[k] - jax_auc[k]) for k in keys}
            print(f"eval f32 drawn on the host with the CPU capstone's keys: {fmt(host_auc)}, pose errors deg "
                  f"{[round(e, 4) for e in host_err]}; JAX (CPU capstone): match error p50 {jax_err['p50']:.5f} "
                  f"p95 {jax_err['p95']:.5f} (f32 off by {abs(err['p50'] - jax_err['p50']):.2e} / "
                  f"{abs(err['p95'] - jax_err['p95']):.2e} px, bar {EVAL_PX}), {fmt(jax_auc)}; AUC delta pp {d}",
                  flush=True)
            require(max(d.values()) <= EVAL_PP, f"eval: AUC off JAX's by {d} pp (bar {EVAL_PP})")
            check_identical_uniforms(*res[xi.scene_tag(0)])
            t0 = time.perf_counter()
            card = [card_auc[label]["auc_5"]] + [scores(xi.PrecomputedMatcher(res), seed)[0]["auc_5"]
                                                 for seed in range(1, EVAL_SEEDS)]
            host = [scores(host_generator_matcher(res), seed)[0]["auc_5"] for seed in range(EVAL_SEEDS)]
            se = math.sqrt(np.var(card, ddof=1) / len(card) + np.var(host, ddof=1) / len(host))
            gap = np.mean(card) - np.mean(host)
            print(f"eval f32 AUC@5 over benchmark seeds 0-{EVAL_SEEDS - 1} ({time.perf_counter() - t0:.1f} s): "
                  f"drawn on the card {spread(card)}; drawn from CPU generators {spread(host)}; gap "
                  f"{gap:+.5f} = {gap / se:+.2f} standard errors (bar {EVAL_SE})", flush=True)
            require(abs(gap) <= EVAL_SE * se, f"eval: the card's draws score {gap:+.5f} AUC@5 off the CPU "
                                              f"generator's over {EVAL_SEEDS} seeds ({gap / se:+.2f} SE)")
        del m, net
        torch.cuda.empty_cache()
    print(f"eval bf16 match error off f32: p50 {abs(errs['bf16']['p50'] - errs['f32']['p50']):.2e} p95 "
          f"{abs(errs['bf16']['p95'] - errs['f32']['p95']):.2e} px", flush=True)
    d = {k: 100 * abs(card_auc["bf16"][k] - card_auc["f32"][k]) for k in keys}
    bar = ref["amp_bar_pp"]
    print(f"eval bf16 vs f32, drawn on the card with the same keys, AUC delta pp {d} "
          f"(bar {bar:.4f}: JAX's bf16-vs-f32 delta + 0.5)", flush=True)
    require(max(d.values()) <= bar, f"eval: the amp path's AUC is off the f32 one by {d} pp (bar {bar})")
    print(f"eval phase: {time.perf_counter() - t_phase:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# the int8 serving path (vit_int8, refiner_int8) and the release gate
# ---------------------------------------------------------------------------

# int8_matmul at the released shapes: the ViT's proj, fc1 and fc2 over both
# images of the symmetric coarse pass (2 x 1601 tokens at 560^2), and each
# refiner width at a 4-row batch (under the 17 rows _int_mm takes on the card)
INT8_SHAPES = (("ViT proj, 2 x 1601 tokens", 3202, 1024, 1024), ("ViT fc1, 2 x 1601 tokens", 3202, 1024, 4096),
               ("ViT fc2, 2 x 1601 tokens", 3202, 4096, 1024), ("refiner C1377, 4 rows", 4, 1377, 1377),
               ("refiner C1137, 4 rows", 4, 1137, 1137), ("refiner C569, 4 rows", 4, 569, 569),
               ("refiner C144, 4 rows", 4, 144, 144))
INT8_REQUESTS = 3
# the release phase's resolution: stage 3's float32 plain pass runs on the
# host's CPU (39.3 s at 560 -> 864 on the H100 machine's 8 cores), which must
# stay within about 90 s to keep the script well inside its time limit
RELEASE_RES = (560, 864)


def int8_products_per_request(cfg, max_c: int = 32) -> int:
    """The int8 products of one symmetric two-pass request (both images in
    one batch): proj, fc1 and fc2 of each ViT block in the coarse pass, and
    the 1x1 of block1 and of each hidden block of every refiner stack wider
    than Kernel D's MAX_C (narrower ones run folded on D), at scales 16-2 of
    the coarse pass and 8-2 of the upsample pass."""
    wide = [s for s, spec in cfg.refiner_specs().items() if spec.hidden_dim > max_c]
    stacks = len(wide) + len([s for s in wide if s != 16])
    return 3 * cfg.dino_depth * cfg.vit_int8 + (1 + cfg.hidden_blocks) * stacks * cfg.refiner_int8


def int8_operands(gen, m, k, n, dt):
    """Rows of different scales, a (K, N) weight of unit-scale outputs, a bias."""
    import torch

    x = torch.randn(m, k, generator=gen) * (0.1 + 3 * torch.rand(m, 1, generator=gen))
    return x.to(dt), torch.randn(k, n, generator=gen) / math.sqrt(k), 0.1 * torch.randn(n, generator=gen)


def int8_one_rounded_the_other_way(x, w_kn, b):
    """int8_matmul's formula with one int8 activation rounded the other way
    (row 0's value nearest a rounding tie): the planted fault that the
    bitwise check must catch."""
    import torch

    from roma_tpu_torch.ops.int8 import quantize, quantize_weight

    xf = x.float()
    xq, sx = quantize(xf, dim=1)
    r = xf[0] / sx[0]
    j = int((r - r.floor() - 0.5).abs().argmin())
    xq[0, j] += 1 if xq[0, j] < r[j] else -1
    wq, sk = quantize_weight(w_kn.t())
    return ((torch._int_mm(xq, wq.t()).float() * sx * sk) + b.float()).to(x.dtype)


def check_int8_products():
    """int8_matmul on the card against the same call on the CPU, bit for bit,
    at INT8_SHAPES in bfloat16 and float32 (the card pads K, N and the rows
    for _int_mm; the CPU does not), and the planted fault must differ from
    the card's result."""
    import torch

    from roma_tpu_torch.ops.int8 import int8_matmul, int8_product

    gen = torch.Generator().manual_seed(0)
    int8_product.launches = 0
    for label, m, k, n in INT8_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, w, b = int8_operands(gen, m, k, n, dt)
            cpu = int8_matmul(x, w, b)
            card = int8_matmul(x.cuda(), w.cuda(), b.cuda()).cpu()
            require(card.dtype == dt and torch.equal(card, cpu),
                    f"int8_matmul {label} {dt}: the card's result is not the CPU's bit for bit "
                    f"(max diff {(card.float() - cpu.float()).abs().max().item():.3e})")
            require(not torch.equal(card, int8_one_rounded_the_other_way(x, w, b)),
                    f"int8_matmul {label} {dt}: the planted fault does not break the bitwise check")
            print(f"int8_matmul {label:28s} ({m}, {k}, {n}) {str(dt)[6:]:8s} card == cpu bit for bit; "
                  f"one value rounded the other way breaks it", flush=True)
    require(int8_product.launches == 2 * len(INT8_SHAPES), f"int8 products launched {int8_product.launches}")


def write_pair_pngs(pair, d: str) -> tuple[str, str]:
    paths = os.path.join(d, "pair_A.png"), os.path.join(d, "pair_B.png")
    for im, path in zip(pair, paths):
        im.save(path)
    return paths


def flow_drift(ref: dict, got: dict, res: dict) -> dict:
    """Per-scale flow drift of ``got`` from ``ref`` (validate_release.two_pass
    outputs) in px of each pass: p50, p99 and the coarse anchor flip rate."""
    import numpy as np

    from roma_tpu_torch.experiments.validate_release import anchor_flips

    out = {}
    for p in ref:
        for s in ref[p]:
            d = np.abs(got[p][s] - ref[p][s]) * res[p] / 2
            out[f"{p}_s{s}"] = {"p50_px": float(np.percentile(d, 50)), "p99_px": float(np.percentile(d, 99)),
                                "anchor_flip_rate": float(anchor_flips(got[p][s], ref[p][s], res[p]).mean())}
    return out


def check_int8(bf16_model, pairs, bf16_stats: dict, d: str):
    """The int8 phase. (a) check_int8_products. (b) roma_outdoor(vit_int8=True,
    refiner_int8=True) at released widths on the seeded weights of
    ``bf16_model``, bf16 amp, 560 -> 864, symmetric: INT8_REQUESTS requests
    of match + sample(5000) + to_pixel_coordinates on ``pairs``: shapes,
    finite values, Kernels A-D launched and int8_products_per_request
    products in each request. (c) Drift from the bf16 model on the same
    weights and inputs: per-scale flow p50 / p99 px and the coarse anchor
    flip rate, and the int8_drift tool at full dims (printed, not gated).
    (d) Pairs/s, latency and peak memory beside the bf16 model's
    (``bf16_stats``), and one fc1 (2 x 1601 tokens) through QLinear's int8
    path, its _int_mm product alone and the bf16 nn.Linear it replaces."""
    import torch

    from roma_tpu_torch.experiments.validate_release import load_pair_images, two_pass
    from roma_tpu_torch.models.vit import QLinear
    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.ops.int8 import int8_product, padded_int_mm, quantize
    from roma_tpu_torch.tools import int8_drift

    t_phase = time.perf_counter()
    card = smi_line()
    check_int8_products()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m8 = roma_outdoor(device="cuda", seed=0, vit_int8=True, refiner_int8=True)
    expected = int8_products_per_request(m8.net.config)
    gen = torch.Generator(device="cuda").manual_seed(0)
    latencies = []
    for im_a, im_b in pairs[:INT8_REQUESTS]:
        zero_counts()
        int8_product.launches = 0
        t0 = time.perf_counter()
        warp, cert = m8.match(im_a, im_b)
        matches, _ = m8.sample(warp, cert, num=5000, generator=gen)
        kpts_a, kpts_b = m8.to_pixel_coordinates(matches, im_a.height, im_a.width, im_b.height, im_b.width)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        launches = read_counts()
        require(tuple(warp.shape) == (864, 1728, 4) and tuple(cert.shape) == (864, 1728), "int8: output shapes")
        require(bool(torch.isfinite(warp).all() and torch.isfinite(cert).all()
                     and torch.isfinite(kpts_a).all() and torch.isfinite(kpts_b).all()), "int8: non-finite output")
        require(tuple(matches.shape) == (5000, 4) and matches.abs().max().item() <= 1.0, "int8: samples")
        missing = [n for n in MATCH_KERNELS if launches[n] == 0]
        require(not missing, f"int8 request: kernels not launched {missing}")
        require(launches[WIDE_KERNEL] == 0, "int8 request: the int8 stacks must keep their modules, not Kernel N")
        require(int8_product.launches == expected,
                f"int8 request: {int8_product.launches} int8 products, expected {expected}")
    peak = torch.cuda.max_memory_allocated()
    pairs_per_s = (len(latencies) - 1) / sum(latencies[1:])
    print(f"int8 requests: {expected} int8 products in each, as int8_products_per_request counts them; "
          f"A-D launched {dict((n, launches[n]) for n in MATCH_KERNELS)} in the last; card {card}")
    print(f"int8 request latency s: {' '.join(f'{t:.4f}' for t in latencies)}; pairs/s after the first "
          f"{pairs_per_s:.4f} (bf16 model {bf16_stats['pairs_per_s']:.4f}); peak device memory {peak} bytes "
          f"(bf16 model {bf16_stats['peak']}); card {card}", flush=True)

    paths = write_pair_pngs(pairs[0], d)
    ims, _ = load_pair_images(560, 864, *paths)
    res = {"coarse": 560, "up": 864}
    drift = flow_drift(two_pass(bf16_model.net, ims, 560, 864, None), two_pass(m8.net, ims, 560, 864, None), res)
    for k, v in drift.items():
        print(f"int8 drift from the bf16 model {k:10s} p50 {v['p50_px']:.4f} px  p99 {v['p99_px']:.4f} px  "
              f"anchor flips {v['anchor_flip_rate']:.5f}")
    print(f"int8 drift: coarse anchor flip rate {drift['coarse_s16']['anchor_flip_rate']:.5f}; card {card}",
          flush=True)
    del m8, warp, cert
    torch.cuda.empty_cache()
    report = int8_drift.main(["--device", "cuda"])
    print(f"int8_drift (full dims, float32): {json.dumps(report)}; card {card}", flush=True)

    fc1 = bf16_model.net.encoder.dinov2.blocks[0].mlp.fc1
    x = torch.randn(2, 1601, 1024, device="cuda", dtype=torch.bfloat16)
    q = QLinear(1024, 4096, int8=True).cuda()
    with torch.no_grad():
        q.weight.copy_(fc1.weight.float())
        q.bias.copy_(fc1.bias.float())
    xq, _ = quantize(x.reshape(-1, 1024).float(), dim=1)
    wq, _ = q._quantized(q.weight)
    with torch.inference_mode():
        t_int8 = cuda_ms(lambda: q(x))
        t_mm = cuda_ms(lambda: padded_int_mm(xq, wq))
        t_bf16 = cuda_ms(lambda: fc1(x))
    print(f"fc1 (3202 x 1024 -> 4096): QLinear int8 {t_int8:.4f} ms (its _int_mm alone {t_mm:.4f} ms), "
          f"bf16 nn.Linear {t_bf16:.4f} ms; card {card}")
    print(f"int8 phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def check_release(paths, pair, d: str):
    """The release phase: validate_release stages 1-4 on the zoo phase's
    reference-layout pair at RELEASE_RES and released widths, stage 3's
    kernel path on the card against the plain path on the host's CPU, on
    ``pair`` written as PNGs; the coarse classifier pinned by the peaked
    bias (--gm_bias peaked), since the seeded weights have no margins.
    Prints each stage, the flipped anchors beside the p99, the CPU pass's
    time and the phase's."""
    from roma_tpu_torch.experiments import validate_release

    t_phase = time.perf_counter()
    im_a, im_b = write_pair_pngs(pair, d)
    res, up = RELEASE_RES
    args = validate_release.parser().parse_args(
        ["--weights", paths[0], "--dinov2_weights", paths[1], "--res", str(res), "--up", str(up),
         "--im_A", im_a, "--im_B", im_b, "--gm_bias", "peaked", "--device", "cuda",
         "--out", os.path.join(d, "VALIDATE_RELEASE_TORCH.json")])
    try:
        report = validate_release.run(args)
    except validate_release.GateFailure as e:
        raise SmokeFailure(f"release gate: {e}") from e
    for stage in ("convert", "strict_load", "f32_parity", "bf16_drift"):
        require(report[stage]["ok"] is True, f"release gate: stage {stage} did not pass")
    par = report["f32_parity"]
    print(f"release gate at {res} -> {up}: stages 1-4 ok; f32 card vs cpu worst p99 {par['worst_p99_px']:.6f} px "
          f"(bar {validate_release.P99_PX}), worst max {par['worst_max_px']:.4f} px, {par['coarse_anchor_flips']} "
          f"of {par['coarse_cells']} coarse anchors flipped; cpu pass {par['cpu_seconds']:.1f} s, card pass "
          f"{par['device_seconds']:.1f} s; bf16 coarse anchor flip rate "
          f"{report['bf16_drift']['coarse_anchor_flip_rate']}; card {smi_line()}")
    print(f"release phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def check_resize(results):
    """The resize phase, Kernel M (ops/resize.py): tests/test_torch_resize.py's
    card tests (M against its plain version on the card over the CPU
    sweep, both dtypes, bit for bit; match()'s inputs on the single-pair
    pool's PIL pairs against the PIL path, float32 and bf16, bit for bit;
    unsynchronized matches against synchronized ones), then M timed at the
    single-pair traffic's shapes (a pair of 720x960 images to 560^2 and to
    864^2, bf16) beside its plain version, its bound (bytes) and PIL's host
    resize of the same images, the work it took off the host."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_torch_resize as cases

    from roma_tpu_torch.ops.resize import resize_normalize, resize_normalize_reference
    from roma_tpu_torch.utils.image import resize

    for dt in (torch.float32, torch.bfloat16):
        cases.test_kernel_equals_the_plain_path_on_the_card(dt)
    for amp in (False, True):
        cases.test_match_inputs_equal_the_pil_path_on_the_card(amp)
    cases.test_unsynchronized_matches_equal_synchronized_ones()
    print(f"resize: M bit for bit its plain version over {len(cases.SWEEP)} sizes x {len(cases.CONTENTS)} "
          "contents (f32, bf16); match()'s inputs bit for bit the PIL path's (f32, bf16); unsynchronized "
          "matches equal synchronized ones", flush=True)
    torch.cuda.empty_cache()
    pair = synthetic_pair(0)
    x = torch.from_numpy(np.stack([np.asarray(p) for p in pair])).cuda()
    for hw in RESIZE_CANVASES:
        out_bytes = x.shape[0] * hw[0] * hw[1] * 3 * 2
        record(results["resize_normalize"], 0.0,
               Case("resize_normalize", f"2x720x960 -> {hw[0]}x{hw[1]}",
                    lambda hw=hw: resize_normalize(x, hw, torch.bfloat16),
                    lambda hw=hw: resize_normalize_reference(x, hw, torch.bfloat16), bytes=x.numel() + out_bytes))
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        for hw in RESIZE_CANVASES:
            for p in pair:
                np.asarray(resize(p, hw))
        host.append(1e3 * (time.perf_counter() - t0))
    host.sort()
    print(f"resize: PIL on the host, the same 4 resizes (2 images x {len(RESIZE_CANVASES)} canvases): "
          f"{host[len(host) // 2]:.3f} ms (median of 20)", flush=True)


def check_small_match():
    """The whole match on a small configuration: kernels on the card against
    the plain versions on the CPU, one set of weights, float32; with the
    defaults (symmetric, two passes) and non-symmetric and coarse-only."""
    import copy

    import numpy as np

    from roma_tpu_torch.experiments.validate_release import peaked_bias
    from roma_tpu_torch.models import RegressionMatcher, RoMaConfig
    from roma_tpu_torch.models.zoo import build_net, init_random

    cfg = RoMaConfig.small()
    net = init_random(build_net(cfg, "cpu"), seed=1, std=0.1).eval()
    gpu_net = copy.deepcopy(net).to("cuda")
    rs = np.random.RandomState(2)
    a, b = (rs.randn(112, 112, 3).astype(np.float32) for _ in range(2))
    for label, modes, shape in (("symmetric, 112 -> 128", {}, (128, 256, 4)),
                                ("non-symmetric, coarse-only 112", dict(symmetric=False, upsample_preds=False),
                                 (112, 112, 4))):
        bias = peaked_bias(2 if modes.get("symmetric", True) else 1, 8, 8, cfg.cls_res)
        outs = []
        for n in (net, gpu_net):
            m = RegressionMatcher(n, h=112, w=112, upsample_res=(128, 128), **modes)
            w, c = m.match(a, b, gm_logit_bias=bias)
            outs.append((w.cpu(), c.cpu()))
        (wc, cc), (wg, cg) = outs
        ew, ec = (wg - wc).abs().max().item(), (cg - cc).abs().max().item()
        print(f"small match {label} f32: cuda kernels vs cpu plain: warp {ew:.3e} certainty {ec:.3e}",
              flush=True)
        require(tuple(wg.shape) == shape and tuple(cg.shape) == shape[:-1] and ew <= 1e-3 and ec <= 1e-3,
                f"small-config match ({label}) disagrees")


def texture(rs, h, w):
    """(h, w, 3) float32 in [0, 1]: coloured blobs and a sine pattern."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    scale = min(h, w) / 720
    for _ in range(60):
        cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), scale * rs.uniform(10, 80)
        img += rs.uniform(0, 1, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    img += 0.15 * np.sin(xx / rs.uniform(5, 20))[..., None] * np.cos(yy / rs.uniform(5, 20))[..., None]
    return np.clip(img / img.max(), 0, 1)


def synthetic_pair(seed: int, hw=(720, 960)):
    """A textured image and a warped copy of it (rotation, scale, shift)."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    im_a = Image.fromarray((texture(rs, *hw) * 255).astype(np.uint8))
    im_b = im_a.rotate(rs.uniform(-15, 15), resample=Image.BICUBIC,
                       translate=(rs.uniform(-40, 40), rs.uniform(-40, 40)))
    return im_a, im_b


def synthetic_train_batch(b: int, hw, seed: int, device, normalize: bool = True):
    """A training batch: textured images (ImageNet-normalized, or in [0, 1]
    for Tiny RoMa with ``normalize=False``) with B equal to A, one smooth
    positive depth map for both, identity pose, a pinhole K. ``hw`` is a
    side or an (h, w). The GT warp is then the identity, valid over all but
    the last row and column, so every loss term is active."""
    import numpy as np
    import torch

    h, w = (hw, hw) if isinstance(hw, int) else hw
    rs = np.random.RandomState(seed)
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    ims = np.stack([texture(rs, h, w) for _ in range(b)]).astype(np.float32)
    if normalize:
        ims = ((ims - mean) / std).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    depth = 3.0 + 0.5 * np.sin(2 * np.pi * xx * rs.uniform(0.5, 1.5)) * np.cos(2 * np.pi * yy * rs.uniform(0.5, 1.5))
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    batch = {"im_A": ims, "im_B": ims.copy(),
             "im_A_depth": np.repeat(depth[None], b, 0).astype(np.float32),
             "T_1to2": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
             "K1": np.tile(K, (b, 1, 1))}
    batch["im_B_depth"] = batch["im_A_depth"].copy()
    batch["K2"] = batch["K1"].copy()
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# the port's CUDA kernels by their __global__ function's name, for --profile
PORT_KERNEL_NAMES = (("attn_fwd", "A"), ("attn_bwd", "E"), ("local_corr", "B"), ("warp_vec", "C"),
                     ("warp_reg", "C"), ("warp_scalar", "C"), ("refiner_block", "D"), ("refiner_chain", "H"),
                     ("window_warp", "G"), ("compact_miss", "F"), ("wide_block", "I/J"), ("hcw_tc", "J"),
                     ("onehot_dot", "K"), ("window_sum", "L"), ("dw_bn_relu", "N"))


def traced(what: str, fn, top: int = 12):
    """One call of ``fn`` under torch.profiler, ending in a synchronize.
    Prints its wall time, its device time (the CUDA kernels' self times;
    user-annotation ranges left out, as they would count their kernels
    twice; one stream, so no overlap), the idle share 1 - device / wall (an
    upper bound: the profiler's host cost lengthens the wall), the top
    kernels and the port's kernels by letter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev_us = self_device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(map(dev_us, kernels)) / 1e3
    require(dev_ms > 0, f"{what}: the trace shows no device time")
    print(f"profile {what}: wall {wall_ms:.3f} ms, device time {dev_ms:.3f} ms, "
          f"idle share {1 - dev_ms / wall_ms:.3f}", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:5d} calls  {e.key[:110]}")
    by_letter = defaultdict(float)
    for e in kernels:
        letter = next((lt for sub, lt in PORT_KERNEL_NAMES if sub in e.key), None)
        if letter:
            by_letter[letter] += dev_us(e) / 1e3
    print(f"profile {what}: port kernels " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_letter.items())),
          flush=True)


def new_results() -> dict:
    """Each kernel's row of the kernels line, before any case is recorded."""
    return {
        name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": 0,
               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
               "library_ms": None, "device_ms": 0.0, "library_device_ms": None, "device_by": None,
               "_bytes_ms": 0.0, "_ops_ms": 0.0, "_methods": set()}
        for name, (src, rep) in KERNEL_INFO.items()
    }


def kernel_rows(results: dict) -> list[dict]:
    """The rows of a kernels line: each row's bound named by what bounds it
    and its device times by how they were taken."""
    for r in results.values():
        r["bound_by"] = "bytes" if r.pop("_bytes_ms") >= r.pop("_ops_ms") else "operations"
        r["device_by"] = "+".join(sorted(r.pop("_methods")))
    return list(results.values())


def zero_counts():
    from roma_tpu_torch.ops import KERNEL_WRAPPERS

    for f in KERNEL_WRAPPERS:
        f.launches = 0


def read_counts() -> dict:
    from roma_tpu_torch.ops import KERNEL_WRAPPERS

    return {f.__name__: f.launches for f in KERNEL_WRAPPERS}


# ReLU kinks: an activation within float32 noise of 0 takes the other branch
# on the other side, which moves the gradients of the layers around it by a
# few percent of their own largest entry (measured on the CPU, the port
# against itself at 1 and 8 threads). So each gradient leaf is held to 1e-3
# of the largest gradient entry of the model, and the leaves no ReLU mask
# reaches in practice (TransformerDecoder, GP) to 1e-3 of their own.
KINK_FREE = ("decoder.embedding_decoder.", "decoder.gps.")


def check_small_train():
    """One training step on the small configuration: kernels on the card
    against the plain versions on the CPU, same weights, batch and peaked
    anchor bias, float32; on the card once as it is and once under remat
    (the recipe's default: the recompute runs A's forward again before E
    reads its log-sum-exp). Loss, every gradient leaf, BatchNorm running
    stats and parameters after the step must agree within 1e-3 of each
    quantity's largest magnitude: the loss's, the model gradient's
    (KINK_FREE leaves: their own), each running buffer's, and the
    parameters'. Parameters are held as a whole because AdamW's first step
    lr * g / (|g| + 1e-8) makes a zero-initialized bias whose gradient is
    float noise (a conv bias in front of a BatchNorm) +-lr on either side."""
    import copy

    import torch

    from roma_tpu_torch.experiments.validate_release import peaked_bias
    from roma_tpu_torch.models import RoMaConfig
    from roma_tpu_torch.models.zoo import build_net, init_random
    from roma_tpu_torch.train import RobustLosses, make_optimizer, make_train_step

    cfg = RoMaConfig.small()
    net = init_random(build_net(cfg, "cpu"), seed=1, std=0.1).train()
    batch = synthetic_train_batch(2, 112, 5, "cpu")
    # the peaked bias keeps the coarse argmax off near-ties, where one flip
    # would make the two sides' losses and gradients diverge
    bias = torch.from_numpy(peaked_bias(2, 8, 8, cfg.cls_res))

    def one_step(dev, remat):
        n = copy.deepcopy(net).to(dev)
        n.set_remat(remat)
        opt = make_optimizer(n, encoder_lr=2 * 5e-6 / 8, decoder_lr=2 * 1e-4 / 8, milestones=(1000,))
        b = bias.to(dev)
        step = make_train_step(n, RobustLosses(), opt, forward=lambda n, x, b=b: n(x["im_A"], x["im_B"], gm_logit_bias=b))
        zero_counts()
        metrics = step({k: v.to(dev) for k, v in batch.items()})
        counts = read_counts()
        grads = {k: p.grad.cpu() for k, p in n.named_parameters() if p.grad is not None}
        return metrics["loss"].item(), grads, {k: v.cpu() for k, v in n.state_dict().items()}, counts

    lc, gc, sc, _ = one_step("cpu", False)
    gmax = max(g.abs().max().item() for g in gc.values())
    pmax = max(v.abs().max().item() for k, v in sc.items() if v.is_floating_point() and "running_" not in k)
    for remat in (False, True):
        lg, gg, sg, counts = one_step("cuda", remat)
        require(all(counts[k] == n for k, n in train_launches(cfg, remat).items())
                and all(counts[k] == 0 for k in FORWARD_ONLY),
                f"small train step (remat {remat}) launches {counts}")
        worst = {"loss": abs(lg - lc) / abs(lc), "grad (of the model's max)": 0.0, "grad kink-free (own max)": 0.0,
                 "bn stats (own max)": 0.0, "params (of the model's max)": 0.0}
        for k, g in gc.items():
            e = (gg[k] - g).abs().max().item()
            worst["grad (of the model's max)"] = max(worst["grad (of the model's max)"], e / gmax)
            if k.startswith(KINK_FREE):
                worst["grad kink-free (own max)"] = max(worst["grad kink-free (own max)"], e / g.abs().max().item())
        for k, v in sc.items():
            if not v.is_floating_point():
                continue
            e = (sg[k] - v).abs().max().item()
            if k.endswith(("running_mean", "running_var")):
                worst["bn stats (own max)"] = max(worst["bn stats (own max)"], e / v.abs().max().item())
            else:
                worst["params (of the model's max)"] = max(worst["params (of the model's max)"], e / pmax)
        print(f"small train step 112^2 f32, cuda kernels{' under remat' if remat else ''} vs cpu plain, worst "
              "error over each quantity's largest magnitude: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + f"; loss {lg:.6f} vs {lc:.6f}; launches {counts}", flush=True)
        require(all(v <= 1e-3 for v in worst.values()), f"small-config train step (remat {remat}) disagrees")


def train_full_width(results, steps: int = 5, batch_size: int = 4, hw: int = 560, profile: bool = False):
    """The recipe's training at released widths: RoMaConfig() on seeded
    random weights, DINOv2 frozen, bf16 autocast over float32 parameters,
    560^2 non-symmetric, RobustLosses, the batch-scaled AdamW recipe. With
    ``profile``, one more step on the last batch, traced."""
    import torch

    from roma_tpu_torch.models import train_net
    from roma_tpu_torch.train import RobustLosses, get_gt_warp, make_optimizer, make_train_step

    t0 = time.perf_counter()
    net = train_net(device="cuda", seed=0)
    n_steps = 8_000_000 // batch_size  # experiments/train_roma_outdoor.py:58-60
    opt = make_optimizer(net, encoder_lr=batch_size * 5e-6 / 8, decoder_lr=batch_size * 1e-4 / 8,
                         milestones=(int(0.9 * n_steps),))
    step = make_train_step(net, RobustLosses(), opt, amp_dtype=torch.bfloat16)
    batches = [synthetic_train_batch(batch_size, hw, 10 + i, "cuda") for i in range(steps)]
    frozen = {k: p.detach().clone() for k, p in net.named_parameters() if not p.requires_grad}
    before = {k: p.detach().clone() for k, p in net.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in before.values())
    print(f"train_net(RoMaConfig(), 560^2, bf16 autocast, batch {batch_size}): "
          f"{n_train + sum(p.numel() for p in frozen.values())} parameters, {n_train} trainable, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    b0 = batches[0]
    share = {s: get_gt_warp(b0["im_A_depth"], b0["im_B_depth"], b0["T_1to2"], b0["K1"], b0["K2"],
                            H=hw // (14 if s == 16 else s), W=hw // (14 if s == 16 else s))[1].mean().item()
             for s in (16, 8, 4, 2, 1)}
    print("GT warp valid share per scale: " + " ".join(f"{s}: {v:.4f}" for s, v in share.items()))

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        m = step(batch)
        loss, gnorm, nonfinite = m["loss"].item(), m["grad_norm"].item(), m["nonfinite_grads"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"train step {i}: loss {loss:.6f} grad_norm {gnorm:.6e} nonfinite_grads {nonfinite:.0f} "
              f"gm_cls_loss_16 {m['gm_cls_loss_16'].item():.4f} "
              f"delta_regression_loss_1 {m['delta_regression_loss_1'].item():.6f} "
              f"time {times[-1]:.4f} s", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm), f"train step {i}: non-finite loss or grad norm")
        require(nonfinite == 0, f"train step {i}: {nonfinite} non-finite gradient leaves")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"kernel launches during the {steps} training steps: {counts}")
    print("train step time s: " + " ".join(f"{t:.4f}" for t in times))
    print(f"samples/s after the first step: {batch_size * (steps - 1) / sum(times[1:]):.4f}")
    print(f"peak device memory allocated during training: {peak} bytes ({peak / 2**30:.3f} GiB)")
    print(f"card: {smi_line()}", flush=True)
    params = dict(net.named_parameters())
    require(all(torch.equal(params[k], v) for k, v in frozen.items()) and len(frozen) > 0,
            "DINOv2 parameters moved")
    groups = ["encoder.cnn", "decoder.embedding_decoder", "decoder.gps", "decoder.proj",
              *(f"decoder.conv_refiner.{s}" for s in (16, 8, 4, 2, 1))]
    unchanged = [g for g in groups
                 if not any(not torch.equal(params[k], v) for k, v in before.items() if k.startswith(g + "."))]
    require(not unchanged, f"parameter groups the steps left unchanged: {unchanged}")
    cfg = net.config
    for k, n in train_launches(cfg, remat=False).items():
        require(counts[k] == n * steps, f"{k} launched {counts[k]} times in {steps} steps, not {n * steps}")
    require(all(counts[k] == 0 for k in FORWARD_ONLY), f"forward-only kernels launched in training: {counts}")
    results["fused_attention_backward"]["launches"] = counts["fused_attention_backward"]
    if profile:
        traced("train step", lambda: step(batches[-1])["loss"].item())


# the recipe phase's data: a ScanNet-format tree, since the card's Python has
# no h5py for MegaDepth's depth files (a probe of that machine found none);
# the same loader, transforms, training step and benchmark read it
RECIPE_SCENES = 3
RECIPE_FRAMES = 6  # frames a scene, stems 0, 10, ..., 50
RECIPE_IMAGE_WH = (640, 480)  # ScanNet's depth size; colour written at the same size
RECIPE_FOCAL = 500.0
RECIPE_DEPTH_MM = 5000  # a fronto-parallel plane 5 m away
RECIPE_BASELINE = 0.1  # frame i's camera sits 0.1 * i m to the right: 10 px of disparity a frame
RECIPE_STEPS = 5
RECIPE_BATCH = 8  # the recipe's --gpu_batch_size, not cut
RECIPE_BENCH_PAIRS = 16  # two batches of 8


def write_scannet_tree(root: str) -> int:
    """A ScanNet-format training tree (roma_tpu_torch/datasets/scannet.py's
    layout: scannet_indices/<scene>.npz, scans/scans_train/<scene>/{color,
    depth, pose, intrinsic}) of RECIPE_SCENES scenes: one textured plane
    seen by RECIPE_FRAMES cameras on a line, so that frame j is frame i's
    texture shifted by 10 (j - i) px and the GT warp holds over the overlap.
    Every ordered pair of distinct frames is a pair. Returns the count."""
    import numpy as np
    from PIL import Image

    w, h = RECIPE_IMAGE_WH
    n_pairs = 0
    for s in range(RECIPE_SCENES):
        rs = np.random.RandomState(100 + s)
        shift = round(RECIPE_FOCAL * RECIPE_BASELINE * 1000 / RECIPE_DEPTH_MM)
        wide = (texture(rs, h, w + shift * RECIPE_FRAMES) * 255).astype(np.uint8)
        scene = f"scene{s:04d}_00"
        sroot = os.path.join(root, "scans", "scans_train", scene)
        for sub in ("color", "depth", "pose", "intrinsic"):
            os.makedirs(os.path.join(sroot, sub), exist_ok=True)
        K4 = np.eye(4)
        K4[0, 0] = K4[1, 1] = RECIPE_FOCAL
        K4[0, 2], K4[1, 2] = w / 2, h / 2
        np.savetxt(os.path.join(sroot, "intrinsic", "intrinsic_color.txt"), K4, delimiter=" ")
        depth = np.full((h, w), RECIPE_DEPTH_MM, np.uint16)
        depth[:2] = 0  # an invalid band, as real depth maps have
        for i in range(RECIPE_FRAMES):
            stem = 10 * i
            Image.fromarray(wide[:, shift * i:shift * i + w]).save(
                os.path.join(sroot, "color", f"{stem}.jpg"), quality=92)
            Image.frombytes("I;16", (w, h), depth.tobytes()).save(os.path.join(sroot, "depth", f"{stem}.png"))
            cam2world = np.eye(4)
            cam2world[0, 3] = RECIPE_BASELINE * i
            np.savetxt(os.path.join(sroot, "pose", f"{stem}.txt"), cam2world, delimiter=" ")
        names = [[s, 0, 10 * i, 10 * j] for i in range(RECIPE_FRAMES) for j in range(RECIPE_FRAMES) if i != j]
        os.makedirs(os.path.join(root, "scannet_indices"), exist_ok=True)
        np.savez(os.path.join(root, "scannet_indices", f"{scene}.npz"), name=np.array(names, np.int32),
                 score=np.full(len(names), 0.5, np.float32))
        n_pairs += len(names)
    return n_pairs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_recipe(profile: bool = False):
    """The training recipe end to end on the card
    (roma_tpu_torch.experiments.train_roma_outdoor): ``build()`` at the
    recipe's shape (medium 560^2, batch 8, remat, bf16 autocast, no
    pretrained backbone: the weights are not in the repository) under a
    one-rank nccl process group set up from torchrun's environment
    variables, over a ScanNet-format tree in place of MegaDepth's bands
    (write_scannet_tree). 5 steps from the loader: finite losses, samples/s
    after the first (StepTimer over the whole loop iteration: the loader's
    wait, the pinned copy to the card and the step), the host's wait on the
    loader a step, A and
    E launched at their remat counts and B, C, D not at all. Peak memory with
    remat, then one step with remat off at batch 8, whose peak must be
    higher. Resume: save, build a fresh recipe (which loads the newest
    checkpoint), require its state equal to the saved one, take one step on
    the same batch from both and require the parameters to agree within
    1e-3 of their largest entry. Then MegadepthDenseBenchmark over the tree
    at batch 8: EPE and PCK finite and in range, A-D launched. With
    ``profile``, one more step on the last batch, traced, before the step
    without remat."""
    import numpy as np
    import torch

    from roma_tpu_torch.benchmarks import MegadepthDenseBenchmark
    from roma_tpu_torch.datasets import ScanNetBuilder
    from roma_tpu_torch.experiments import train_roma_outdoor as recipe
    from roma_tpu_torch.experiments.common import DeviceBatches, epoch_loader
    from roma_tpu_torch.models import RegressionMatcher
    from roma_tpu_torch.parallel import dist
    from roma_tpu_torch.train import train_k_steps
    from roma_tpu_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    card = smi_line()
    work = tempfile.mkdtemp(prefix="recipe_", dir=os.path.join(HERE, "build"))
    t0 = time.perf_counter()
    n_pairs = write_scannet_tree(os.path.join(work, "scannet"))
    print(f"recipe: wrote a ScanNet-format tree, {RECIPE_SCENES} scenes, {n_pairs} pairs, "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    args = recipe.parser().parse_args([
        "--ckpt_dir", os.path.join(work, "ckpt"), "--gpu_batch_size", str(RECIPE_BATCH),
        "--train_resolution", "medium", "--no-pretrained_backbone", "--distributed", "--num_workers", "8"])
    require(args.remat and args.bf16, "the recipe's defaults must be remat and bf16")

    h, w = recipe.RESOLUTIONS[args.train_resolution]
    ds = ScanNetBuilder(os.path.join(work, "scannet")).build_concat(ht=h, wt=w, use_horizontal_flip_aug=True)
    t0 = time.perf_counter()
    r = recipe.build(args, data=(ds, ScanNetBuilder.weight_scenes(ds, alpha=0.75)))
    torch.cuda.synchronize()
    require(dist.active() and torch.distributed.get_backend() == "nccl" and dist.world_size() == 1,
            "the recipe did not join a one-rank nccl group")
    print(f"recipe: build() in {time.perf_counter() - t0:.2f} s on {r.device}, nccl world size "
          f"{dist.world_size()}, {len(r.dataset)} pairs, {r.n_steps} steps to run", flush=True)
    cfg = r.state.net.config
    loader = epoch_loader(r.dataset, r.weights, r.batch_size, np.random.RandomState(0), args.num_workers)
    require(len(loader) >= RECIPE_STEPS, f"the loader gives {len(loader)} batches, fewer than {RECIPE_STEPS}")
    batches = DeviceBatches(loader, r.device)
    timer = StepTimer(items_per_step=RECIPE_BATCH, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    it = iter(batches)
    try:
        for i in range(RECIPE_STEPS):
            with timer:  # the whole iteration: the loader's wait, the pinned copy to the card, the step
                batch = next(it)
                r.state, m = train_k_steps(r.state, [batch], r.step)
                loss, nonfinite = m["loss"].item(), m["nonfinite_grads"].item()
            print(f"recipe step {i}: loss {loss:.6f} grad_norm {m['grad_norm'].item():.6e} "
                  f"gm_cls_loss_16 {m['gm_cls_loss_16'].item():.4f} wait {batches.waits[i]:.4f} s", flush=True)
            require(math.isfinite(loss) and nonfinite == 0,
                    f"recipe step {i}: loss {loss}, {nonfinite} non-finite leaves")
    finally:
        it.close()  # stops the loader's threads
    last = batch
    counts = read_counts()
    peak_remat = torch.cuda.max_memory_allocated()
    print(f"recipe: kernel launches in {RECIPE_STEPS} steps {counts}")
    for k, n in train_launches(cfg, remat=True).items():
        require(counts[k] == n * RECIPE_STEPS, f"recipe: {k} launched {counts[k]} times, not {n * RECIPE_STEPS}")
    require(all(counts[k] == 0 for k in FORWARD_ONLY), f"recipe: forward-only kernels launched in training {counts}")
    waits = batches.waits[:RECIPE_STEPS]
    print(f"recipe 560^2 batch {RECIPE_BATCH} remat bf16: iteration times (loader, copy, step) after the first "
          + " ".join(f"{t:.4f}" for t in timer.times) + f" s; samples/s {timer.items_per_sec:.4f}; loader wait a "
          f"step {sum(waits) / len(waits):.4f} s (steps 1-{RECIPE_STEPS - 1}: {sum(waits[1:]) / (len(waits) - 1):.4f} s); "
          f"peak device memory with remat {peak_remat} bytes ({peak_remat / 2**30:.3f} GiB); card {card}", flush=True)

    if profile:
        traced("recipe step (remat, batch 8)", lambda: r.step(last)["loss"].item())
    r.state.net.set_remat(False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    r.state, m = train_k_steps(r.state, [last], r.step)
    require(math.isfinite(m["loss"].item()), "recipe: the step without remat gave a non-finite loss")
    peak_plain = torch.cuda.max_memory_allocated()
    plain_counts = read_counts()
    r.state.net.set_remat(True)
    print(f"recipe: one step without remat at batch {RECIPE_BATCH}: peak {peak_plain} bytes "
          f"({peak_plain / 2**30:.3f} GiB), remat's {peak_remat / peak_plain:.4f} of it; A launched "
          f"{plain_counts['fused_attention_packed']} times", flush=True)
    require(peak_remat < peak_plain, "recipe: remat's peak memory is not below the step without it")
    require(all(plain_counts[k] == n for k, n in train_launches(cfg, remat=False).items()),
            f"recipe: without remat {plain_counts}")

    t0 = time.perf_counter()
    r.checkpointer.save(r.state)
    r2 = recipe.build(args, data=(r.dataset, r.weights))
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    sd, sd2 = r.state.net.state_dict(), r2.state.net.state_dict()
    require(r2.state.step == r.state.step == RECIPE_STEPS + 1
            and r2.state.optimizer.count == r.state.optimizer.count
            and all(torch.equal(sd[k], sd2[k]) for k in sd),
            "recipe: the resumed state is not the saved one")
    m1, m2 = r.step(last), r2.step(last)
    p1, p2 = dict(r.state.net.named_parameters()), dict(r2.state.net.named_parameters())
    pmax = max(p.detach().abs().max().item() for p in p1.values())
    perr = max((p1[k] - p2[k]).abs().max().item() for k in p1)
    lerr = abs(m1["loss"].item() - m2["loss"].item()) / abs(m1["loss"].item())
    lrs = [g["lr"] for g in r.state.optimizer.param_groups], [g["lr"] for g in r2.state.optimizer.param_groups]
    print(f"recipe resume: save + build + load {t_resume:.2f} s; one step on the same batch: loss rel. error "
          f"{lerr:.3e}, params max error {perr:.3e} of their largest entry {pmax:.4f} ({perr / pmax:.3e}, bar 1e-3); "
          f"learning rates {lrs[0]} / {lrs[1]}", flush=True)
    require(perr <= 1e-3 * pmax and lerr <= 1e-3 and lrs[0] == lrs[1], "recipe: the resumed step disagrees")
    del r2, m2, p2, sd2
    torch.cuda.empty_cache()

    bench = MegadepthDenseBenchmark(dataset=r.dataset, num_samples=RECIPE_BENCH_PAIRS)
    model = RegressionMatcher(r.state.net, h=h, w=w, upsample_preds=False, symmetric=False)
    zero_counts()
    t0 = time.perf_counter()
    out = bench.benchmark(model, batch_size=RECIPE_BATCH)
    torch.cuda.synchronize()
    t_bench = time.perf_counter() - t0
    bench_counts = read_counts()
    print(f"recipe dense benchmark, {RECIPE_BENCH_PAIRS} pairs at batch {RECIPE_BATCH}, 560^2 float32: {out}; "
          f"wall {t_bench:.3f} s; launches {bench_counts}; card {card}", flush=True)
    require(all(math.isfinite(v) for v in out.values()) and out["epe"] >= 0
            and 0 <= out["mega_pck_1"] <= out["mega_pck_3"] <= out["mega_pck_5"] <= 1,
            f"recipe: dense benchmark out of range {out}")
    require(all(bench_counts[k] > 0 for k in MATCH_KERNELS), f"recipe: the benchmark's match skipped a kernel {bench_counts}")
    dist.shutdown()
    del r, model
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    print(f"recipe phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the convergence phase: the tool's small configuration (head dims of 64, so
# A and E) at the JAX tiny run's 112^2 and batch 8, as many steps as fit in
# about a minute on the card (250 in the JAX tiny run; a step took 0.34-0.59 s
# on the H100's host, whose dispatch bounds it)
CONVERGENCE_STEPS, CONVERGENCE_RES, CONVERGENCE_BATCH, CONVERGENCE_EVALS = 100, 112, 8, 3


def check_convergence(results):
    """The convergence phase: roma_tpu_torch.tools.convergence_run's main at
    --config small (RoMaConfig.small()), CONVERGENCE_RES^2, batch
    CONVERGENCE_BATCH, CONVERGENCE_STEPS steps of the full recipe, in this
    process, its report written to a temporary directory. Requires no step
    with a non-finite gradient, finite BatchNorm statistics, the mean loss of
    the last 3 logs below that of the first 3, PCK@5 after training above
    PCK@5 before, and A and E launched as often as the steps and the three
    evaluations' forwards need (train_launches), no other kernel; their
    counts are added to rows 1 and 3. Prints loss, PCK and EPE before and
    after (raw and EMA) and the steps a second."""
    import torch

    from roma_tpu_torch.models import RoMaConfig
    from roma_tpu_torch.tools import convergence_run

    t_phase = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory() as d:
        r = convergence_run.main(["--config", "small", "--res", str(CONVERGENCE_RES), "--batch",
                                  str(CONVERGENCE_BATCH), "--steps", str(CONVERGENCE_STEPS),
                                  "--log_every", str(CONVERGENCE_STEPS // 10),
                                  "--tag", "smoke"], out_dir=d)
    counts = read_counts()
    torch.cuda.empty_cache()
    per_step = train_launches(RoMaConfig.small(), remat=False)
    want = {n: c * CONVERGENCE_STEPS for n, c in per_step.items()}
    want["fused_attention_packed"] += CONVERGENCE_EVALS * per_step["fused_attention_packed"]
    print(f"convergence: RoMaConfig.small() at {CONVERGENCE_RES}^2, batch {CONVERGENCE_BATCH}, {CONVERGENCE_STEPS} "
          f"steps: loss {r['loss_first3_logged']:.6f} -> {r['loss_last3_logged']:.6f} (means of the first and last 3 "
          f"logs); PCK@1/3/5 {r['eval_pck_before']} -> {r['eval_pck_after']} (EMA {r['eval_pck_after_ema']}); "
          f"EPE {r['eval_epe_px_before']:.4f} -> {r['eval_epe_px_after']:.4f} px (EMA "
          f"{r['eval_epe_px_after_ema']:.4f}); non-finite gradient steps {r['nonfinite_grad_steps']}; BatchNorm "
          f"statistics finite {r['bn_stats_finite']}; {r['steps_per_s']:.4f} steps/s, the host's wait on the next "
          f"batch {r['batch_wait_s']:.4f} s a step; launches {counts}; "
          f"card {r['card']}; phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    require(r["nonfinite_grad_steps"] == 0, f"convergence: {r['nonfinite_grad_steps']} steps with non-finite gradients")
    require(r["bn_stats_finite"], "convergence: non-finite BatchNorm statistics")
    require(r["loss_last3_logged"] < r["loss_first3_logged"], "convergence: the loss did not fall")
    require(r["eval_pck_after"]["pck_5"] > r["eval_pck_before"]["pck_5"], "convergence: PCK@5 did not rise")
    require(counts == {**dict.fromkeys(counts, 0), **want} and r["launches"] == counts,
            f"convergence: launches {counts}, want {want}")
    for n in want:
        results[n]["launches"] += counts[n]


REPLICA_DEVICES, REPLICA_BATCH, REPLICA_SHARD = ("cuda:0", "cuda:0"), 8, 4


def check_replicas(results):
    """The replicas phase: MatchEngine(model, batch_size=4) over the serve
    phase's stream of 24 synthetic pairs (its 9 PNG pairs in turn), then
    MatchEngine(model, batch_size=8, devices=["cuda:0", "cuda:0"]) over the
    same stream: two replicas on the one card, the second a copy of the
    model, every shard a batch of 4, which exercises the split, the
    per-device copy streams and events and the gather (not two cards). The
    model is roma_outdoor at released widths (bf16 amp, 560 -> 864). With
    the coarse classifier pinned by the serve phase's peaked bias on every
    replica, each pair's warp and certainty from the two replicas agree
    with the one replica's to the bf16 bar (4.0e-2 at max|p| = 1) and every
    call of every replica launches A-D; the two replicas' launches are
    added to rows 1, 4, 6 and 8. Each engine is then timed unpinned over
    the stream after its pinned run, the one replica's before the copy
    exists: pairs/s and peak memory side by side."""
    import numpy as np
    import torch

    from roma_tpu_torch.experiments.validate_release import peaked_bias
    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.serving import MatchEngine

    t_phase = time.perf_counter()
    model = roma_outdoor(device="cuda", seed=0)
    field = peaked_bias(2, model.h_resized // 14, model.w_resized // 14, model.net.config.cls_res)
    calls = []

    def pin(m, replica: int):
        match = m.match

        def pinned(*a, **kw):  # the symmetric batch is [A_i -> B_i ..., B_i -> A_i ...]
            b = a[0].shape[0]
            before = read_counts()
            out = match(*a, gm_logit_bias=np.concatenate([np.repeat(field[:1], b, 0), np.repeat(field[1:], b, 0)]),
                        **kw)
            after = read_counts()
            calls.append((replica, b, {n: after[n] - before[n] for n in MATCH_KERNELS}))
            return out

        m.match = pinned

    def run(engine, stream):
        """The pinned results and their calls, then the unpinned stream timed."""
        for i, m in enumerate(engine.replicas):
            pin(m, i)
        try:
            out = list(engine.match_paths(stream))
            made = list(calls)
            calls.clear()
        finally:
            for m in engine.replicas:
                del m.match
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n = sum(1 for r in engine.match_paths(stream) if r.error is None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(n == len(stream), f"replicas: batch {engine.batch_size} matched {n} pairs")
        return out, made, len(stream) / wall, torch.cuda.max_memory_allocated()

    with tempfile.TemporaryDirectory() as d:
        files = []
        for k in range(SERVE_PAIRS):
            pair = []
            for im, side in zip(synthetic_pair(100 + k), "ab"):
                pair.append(os.path.join(d, f"{side}{k}.png"))
                im.save(pair[-1])
            files.append(tuple(pair))
        stream = [files[k % SERVE_PAIRS] for k in range(SERVE_TIMED_PAIRS)]
        want, one_calls, one_rate, one_peak = run(MatchEngine(model, batch_size=REPLICA_SHARD), stream)
        two = MatchEngine(model, batch_size=REPLICA_BATCH, devices=REPLICA_DEVICES)
        require(two.replicas[0] is model and two.replicas[1].net is not model.net, "replicas: not one copy a device")
        got, two_calls, two_rate, two_peak = run(two, stream)
    require([r.index for r in got] == [r.index for r in want] == list(range(SERVE_TIMED_PAIRS)),
            "replicas: results out of order")
    n_batches = SERVE_TIMED_PAIRS // REPLICA_BATCH
    require([c[:2] for c in two_calls] == [(0, REPLICA_SHARD), (1, REPLICA_SHARD)] * n_batches,
            f"replicas: calls {[c[:2] for c in two_calls]}")
    require(all(all(c[2][n] > 0 for n in MATCH_KERNELS) for c in two_calls + one_calls),
            "replicas: a call launched no A, B, C or D")
    equal = 0
    for g, w in zip(got, want):
        require(g.warp.device == w.warp.device == two.devices[0], "replicas: results off the first device")
        check_output("replicas", f"pair {g.index} vs one replica", torch.bfloat16, g.warp, w.warp, "warp ")
        check_output("replicas", f"pair {g.index} vs one replica", torch.bfloat16, g.certainty, w.certainty,
                     "certainty ")
        equal += bool(torch.equal(g.warp, w.warp) and torch.equal(g.certainty, w.certainty))
    for n in MATCH_KERNELS:
        results[n]["launches"] += sum(c[2][n] for c in two_calls)
    print(f"replicas: {SERVE_TIMED_PAIRS} pairs, batch {REPLICA_BATCH} over {list(REPLICA_DEVICES)} (shards of "
          f"{REPLICA_SHARD}) against batch {REPLICA_SHARD} on one replica: every pair within the bf16 bar, "
          f"{equal} of {len(got)} bit for bit; launches a call "
          + "; ".join(f"replica {c[0]}: " + ", ".join(f"{n} {c[2][n]}" for n in MATCH_KERNELS)
                      for c in two_calls[:2]), flush=True)
    print(f"replicas: two replicas, batch {REPLICA_BATCH}: {two_rate:.4f} pairs/s, peak device memory {two_peak} "
          f"bytes; one replica, batch {REPLICA_SHARD}: {one_rate:.4f} pairs/s, peak {one_peak} bytes (timed "
          f"unpinned after each engine's pinned run, {SERVE_TIMED_PAIRS} pairs each)", flush=True)
    del model, two, got, want
    torch.cuda.empty_cache()
    print(f"replicas phase: {time.perf_counter() - t_phase:.2f} s; card {smi_line()}", flush=True)


def run_sdpa_path(results):
    """The per-head attention op as a caller uses it: ops.sdpa forward and
    backward at the DINOv2 shape, bf16."""
    import torch

    from roma_tpu_torch import ops

    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(8, 16, 1601, 64, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    zero_counts()
    out = ops.sdpa(q, k, v)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"ops.sdpa forward + backward (8, 16, 1601, 64) bf16: launches {counts}", flush=True)
    require(all(counts[k] >= 1 for k in SDPA_KERNELS), f"sdpa path launches {counts}")
    require(all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v)), "non-finite sdpa gradients")
    results["fused_attention"]["launches"] = counts["fused_attention"]


def speckled_flow(gen, b, h, w, frac=0.02):
    """smooth_flow at a fifth of its noise, with a fraction ``frac`` of the
    queries thrown by a unit normal: the speckle outliers the v2 sampler's
    fixups exist for. At smooth_flow's own amplitude (0.1, ~43 px at 864)
    a 16x16 tile's targets spread past its 64-row window and most tiles
    overflow; here only the row of tiles on the off-image band's edge does,
    and those are recomputed exactly."""
    import torch

    f = smooth_flow(gen, b, h, w, scale=0.02)
    sp = torch.rand(b, h, w, 1, generator=gen, device="cuda") < frac
    return (f + sp * torch.randn(b, h, w, 2, generator=gen, device="cuda")).contiguous()


def gentle_flow(gen, b, h, w):
    """The identity plus 0.02x smooth_flow's noise, no off-image band, and
    0.5% speckle off the last query row and column: ~20 misses in a 64x64
    v1 tile, so the fixups run and every tile stays within its 64 slots
    (v1 has no tile recompute). A partial tile repeats its last row and
    column (edge padding), which would copy a speckle there 33 times."""
    import torch

    f = smooth_flow(gen, b, h, w, off_band=False, scale=0.002)
    sp = torch.rand(b, h, w, 1, generator=gen, device="cuda") < 0.005
    sp[:, -1] = False
    sp[:, :, -1] = False
    return (f + sp * torch.randn(b, h, w, 2, generator=gen, device="cuda")).contiguous()


def tile_cost(args):
    """(bytes, ops) of one Kernel G call: the image, the tile fields and
    fixups in, the tiles out; ~8 ops per in-window element, 1 per fixup."""
    x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, _ = args
    ins = (x, yl, xl, fy, fx, oy, ox, fpos, fval)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + yl.numel() * x.shape[-1] * x.element_size()
    n_ok = int(((yl >= 0) & (yl <= wh - 2) & (xl >= 0) & (xl <= ww - 2)).sum())
    return nbytes, x.shape[-1] * (8 * n_ok + int((fpos < yl.shape[1]).sum()))


def check_bits(name, label, dt, k, p, what: str = "") -> float:
    """check_output, and the same bits: Kernel G computes its plain
    version's products and sums in the same order, uncontracted."""
    err = check_output(name, label, dt, k, p, what)
    require(err == 0.0, f"{name} {label} {dt} {what}: not bitwise equal to its plain version")
    return err


def whole(name, label, dt, fn, x, flow, branches, took):
    """A windowed function as a whole against warp_sample_reference, and the
    set of branches it took."""
    from roma_tpu_torch import ops

    before = dict(branches)
    got = fn(x, flow)
    check_output(name, label, dt, got, ops.warp_sample_reference(x, flow), "whole function ")
    moved = {k: v - before[k] for k, v in branches.items() if v != before[k]}
    require(set(moved) == took, f"{name} {label}: branches {moved}, expected {took}")
    return got


def host_us(fn, n: int = 300) -> float:
    """Median host time, in us, of one call of ``fn`` started on an empty
    launch queue (a synchronize before each call, outside the clock)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    times.sort()
    return 1e6 * times[len(times) // 2]


def wrapper_host_parts(args, library):
    """Kernel G's wrapper part by part at the shape of ``args``: the host
    time of the whole call and of each step it takes, beside the library
    call's and the stream accessor the wrapper does not use."""
    import torch

    from roma_tpu_torch import _ext, ops
    from roma_tpu_torch.ops import tile_window as tw

    x, yl, fpos = args[0], args[1], args[7]
    out = ops.warp_tiles(*args)
    ptrs = [a.data_ptr() for a in (*args[:9], out)]
    entry = _ext.lib().roma_window_warp
    dims = (yl.shape[0], yl.shape[0] // x.shape[0], *x.shape[1:], yl.shape[1], fpos.shape[1], *args[9:],
            _ext.dtype_code(x, "warp_tiles"))
    parts = (("warp_tiles, the whole call", lambda: ops.warp_tiles(*args)),
             ("tile_checks", lambda: tw.tile_checks("warp_tiles", *args[:9])),
             ("torch.empty", lambda: torch.empty_like(out)),
             ("ten data_ptr", lambda: [a.data_ptr() for a in (*args[:9], out)]),
             ("_ext.stream()", _ext.stream),
             ("the ctypes launch", lambda: entry(*ptrs, *dims, _ext.stream())),
             ("torch.cuda.current_stream().cuda_stream", lambda: torch.cuda.current_stream().cuda_stream),
             ("F.grid_sample, the whole call", library))
    print("host time a call, median of 300 on an empty launch queue: "
          + ", ".join(f"{name} {host_us(fn):.2f} us" for name, fn in parts), flush=True)


def compact_case(gen, bnt, t, kf, density):
    """Kernel F at one of the samplers' shapes: the Case, the flags and the
    path compact_checks picks."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops import window_util as wu

    miss = torch.rand(bnt, 1, t, generator=gen, device="cuda") < density
    case = Case("compact_miss", "", lambda: ops.compact_miss(miss, t, kf),
                lambda: ops.compact_miss_reference(miss, t, kf), bytes=bnt * t + 4 * bnt * kf, ops=bnt * t)
    return case, miss, wu.compact_checks(miss, t, kf)


# Kernel F's shapes: the v2 sampler's tiles at 864^2 and the v1 sampler's
COMPACT_SHAPES = (("v2 864^2 5832 x T256 kf32", 5832, 256, 32), ("v1 864^2 392 x T4096 kf64", 392, 4096, 64))
COMPACT_DENSITIES = (0.005, 0.05, 0.5)


def check_compact_kernel(results, gen):
    """Kernel F against its plain version, exactly, at COMPACT_SHAPES and
    COMPACT_DENSITIES, on the path compact_checks picks and on the generic
    path forced through the entry; the planted fault must break the exact
    check. The row gets F's paths. F's first design and its launch floor
    are timed beside it by tools/kernel_variants.py (f_first_design,
    f_probe_floor)."""
    import torch

    from roma_tpu_torch import _ext
    from roma_tpu_torch.ops import window_util as wu

    r = results["compact_miss"]
    paths = set()
    for label, bnt, t, kf in COMPACT_SHAPES:
        for density in COMPACT_DENSITIES:
            case, miss, path = compact_case(gen, bnt, t, kf, density)
            case.label = f"{label} {density:g}"
            got, ref = case.kern(), case.plain()
            torch.cuda.synchronize()
            require(torch.equal(got, ref), f"compact_miss {case.label}: kernel disagrees with its plain version")
            print(f"{'compact_miss':26s} {case.label:30s} int32    exact on the {path} path, "
                  f"{int((ref < t).sum())} slots filled", flush=True)
            check_power("compact_miss", case.label, "", ref, compact_rank_off_by_one(miss, t, kf),
                        FAULTS["compact_miss"], exact=True)
            record(r, 0.0, case, "bool")
            paths.add(path)
            out = torch.empty_like(ref)
            _ext.check(_ext.lib().roma_compact_miss(miss.data_ptr(), out.data_ptr(), bnt, t, kf,
                                                    wu.PATH_CODES["generic"], _ext.stream()), "compact_miss generic")
            torch.cuda.synchronize()
            require(torch.equal(out, ref), f"compact_miss {case.label}: the generic path disagrees")
    r.update(path="+".join(sorted(paths)))
    print(f"compact_miss over its {len(COMPACT_SHAPES) * len(COMPACT_DENSITIES)} calls: device {r['device_ms']:.4f} "
          f"ms on the {r['path']} paths, bound {r['bound_ms']:.4f} ms; the generic path exact too", flush=True)


def check_window_kernels(results):
    """Kernels F, G and H against their plain versions at the JAX design
    shapes (B = 2), and windowed_warp / windowed_grid_sample as a whole
    against warp_sample_reference, each case's branch asserted."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.graveyard import window_warp_v1 as v1
    from roma_tpu_torch.ops import tile_window as tw

    gen = torch.Generator(device="cuda").manual_seed(3)
    check_compact_kernel(results, gen)

    spec, spec1 = tw.WarpSpec(), v1.WindowSpec()
    for dt in (torch.float32, torch.bfloat16):
        rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
        # Kernel G, v2 entry: the scale-1 x_hat (C = 9) at both passes' sizes
        for hw in (560, 864):
            label = f"v2 {hw}^2 C9 speckle 2%"
            x, flow = rn(2, hw, hw, 9), speckled_flow(gen, 2, hw, hw)
            plan = tw._plan(flow, hw, hw, spec)
            args = tw._tile_args(x, plan, spec)
            nbytes, nops = tile_cost(args)
            case = Case("warp_tiles", label, lambda a=args: ops.warp_tiles(*a),
                        lambda a=args: ops.warp_tiles_reference(*a), bytes=nbytes, ops=nops,
                        library=grid_sample_library(x, flow))
            err = check_bits("warp_tiles", label, dt, case.kern(), case.plain())
            counts = plan["counts"].reshape(-1)
            print(f"{'':26s} {label:30s} tiles {counts.numel()}, needs-fix per tile max {int(counts.max())}, "
                  f"over budget {int((counts > spec.kf).sum())}", flush=True)
            took = {"tile_recompute"} if bool((counts > spec.kf).any()) else set()
            whole("windowed_warp", label, dt, ops.windowed_warp, x, flow, ops.windowed_warp.branches, took)
            if dt == torch.bfloat16:
                record(results["warp_tiles"], err, case)
                if hw == 864:
                    wrapper_host_parts(args, case.library)
        # the wild flow: more over-budget tiles than the recompute takes
        x, flow = rn(2, 864, 864, 9), 2.5 * torch.randn(2, 864, 864, 2, generator=gen, device="cuda")
        counts = tw._plan(flow, 864, 864, spec)["counts"]
        print(f"{'':26s} {'v2 864^2 C9 wild 2.5 randn':30s} over budget {int((counts > spec.kf).sum())} "
              f"of {counts.numel()} tiles", flush=True)
        got = whole("windowed_warp", "v2 864^2 C9 wild", dt, ops.windowed_warp, x, flow,
                    ops.windowed_warp.branches, {"exact"})
        require(torch.equal(got, ops.warp_sample_reference(x, flow)), "wild case: exact branch not exact")
        # Kernel G, v1 entry: 64x64 tiles at 864^2, a flow no tile overflows on
        label = "v1 864^2 C9 gentle"
        x, flow = rn(2, 864, 864, 9), gentle_flow(gen, 2, 864, 864)
        plan = v1._plan(flow, 864, 864, spec1)
        args = v1._tile_args(x, plan, spec1)
        nbytes, nops = tile_cost(args)
        case = Case("warp_tiles_v1", label, lambda a=args: ops.warp_tiles_v1(*a),
                    lambda a=args: ops.warp_tiles_reference(*a), bytes=nbytes, ops=nops,
                    library=grid_sample_library(x, flow))
        err = check_bits("warp_tiles_v1", label, dt, case.kern(), case.plain())
        most = int(plan["miss"].sum(-1).max())
        print(f"{'':26s} {label:30s} tiles {plan['miss'].shape[0] * plan['nt']}, misses per tile max "
              f"{most} (kf {spec1.kf})", flush=True)
        require(most > 0, f"windowed_grid_sample {label}: no miss, the fixups were not exercised")
        whole("windowed_grid_sample", label, dt, v1.windowed_grid_sample, x, flow,
              v1.windowed_grid_sample.branches, set())
        if dt == torch.bfloat16:
            record(results["warp_tiles_v1"], err, case)

    # Kernel H: the scale-1 refiner stack, 9 folded blocks of C = 24, beside
    # Kernel D on the same inputs (call and device time)
    blocks = refiner_blocks(gen)
    for dt in (torch.float32, torch.bfloat16):
        for hw in (560, 864):
            label = f"s1 {hw}^2 C24 x9"
            x = torch.randn(2, hw, hw, 24, generator=gen, device="cuda").to(dt)
            nbytes, pw_ops, dw_ops, peak, path = packed_cost(x, blocks)
            case = Case("fused_refiner_stack_packed", label, lambda x=x: ops.fused_refiner_stack_packed(x, blocks),
                        lambda x=x: ops.refiner_stack_reference(x, blocks), bytes=nbytes, ops=pw_ops, peak=peak,
                        f32_ops=dw_ops, planted=lambda x=x: refiner_edge_clamped(x, blocks))
            got = case.kern()
            ref = case.plain()
            err = check_output(case.name, f"{label} {path}", dt, got, ref)
            check_output(case.name, f"{label} {path}", dt, got, ops.fused_refiner_stack(x, blocks), "vs Kernel D ")
            if dt == torch.bfloat16:
                check_power(case.name, label, "", ref, case.planted(), FAULTS[case.name])
                record(results[case.name], err, case)
                d = lambda x=x: ops.fused_refiner_stack(x, blocks)  # noqa: E731
                dms = cuda_ms(d)
                r = results[case.name]
                r["d_ms"] = r.get("d_ms", 0.0) + dms
                r["d_device_ms"] = r.get("d_device_ms", 0.0) + device_ms(d, dms)[0]
                bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
                print(f"{'':26s} {label:30s} bf16     Kernel D {dms:.4f} ms (device {r['d_device_ms']:.4f} "
                      f"summed so far); bound {max(bytes_ms, case.ops_ms()):.4f} ms, "
                      f"{max(bytes_ms, 1e3 * (pw_ops + dw_ops) / PEAK_F32):.4f} with the pointwise in f32 "
                      f"on the CUDA cores", flush=True)
            del ref
        torch.cuda.empty_cache()


def edge_slots(args, positions, gen):
    """Kernel G's arguments with every tile's fixup slots replaced: the
    query ``positions`` (distinct, in no order) in the first slots, the
    sentinel T in the rest, random fixup values in all."""
    import torch

    x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm = args
    pos = torch.full_like(fpos, yl.shape[1])
    pos[:, : len(positions), 0] = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return (x, yl, xl, fy, fx, oy, ox, pos, torch.randn(fval.shape, generator=gen, device="cuda"), wh, ww, pm)


# fixup positions at a tile's first and last query and on both sides of the
# boundaries between 256-query blocks, as a v1 tile (T = 4096) and a v2
# tile (T = 256) are split
EDGE_SLOTS = {"warp_tiles_v1": (4095, 0, 255, 256, 2047, 2048, 511, 512, 3839, 3840),
              "warp_tiles": (255, 0, 127, 128)}


def check_window_edges():
    """Kernel G's two entries at the edges of their block split, bf16 and
    f32, against warp_tiles_reference (bitwise), and the windowed functions as a
    whole against warp_sample_reference: v1's partial tiles at 560^2 (560 =
    8 * 64 + 48), EDGE_SLOTS, and widths other than the model's 9 (4 and 5,
    and 3, which no template instantiates)."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.graveyard import window_warp_v1 as v1
    from roma_tpu_torch.ops import tile_window as tw

    gen = torch.Generator(device="cuda").manual_seed(9)
    spec, spec1 = tw.WarpSpec(), v1.WindowSpec()
    for dt in (torch.float32, torch.bfloat16):
        for c in (9, 5, 4, 3):
            x = torch.randn(2, 560, 560, c, generator=gen, device="cuda").to(dt)
            flow1, flow2 = gentle_flow(gen, 2, 560, 560), speckled_flow(gen, 2, 560, 560)
            plan1, plan2 = v1._plan(flow1, 560, 560, spec1), tw._plan(flow2, 560, 560, spec)
            args = {"warp_tiles_v1": v1._tile_args(x, plan1, spec1), "warp_tiles": tw._tile_args(x, plan2, spec)}
            for name, a in args.items():
                label = f"{name[-2:] if name.endswith('v1') else 'v2'} 560^2 C{c}"
                fn = getattr(ops, name)
                check_bits(name, label, dt, fn(*a), ops.warp_tiles_reference(*a))
                e = edge_slots(a, EDGE_SLOTS[name], gen)
                check_bits(name, label + " edge slots", dt, fn(*e), ops.warp_tiles_reference(*e))
            require(plan1["nh"] * 64 > 560 and int(plan1["miss"].sum(-1).max()) > 0,
                    "v1 560^2: no partial tile or no miss")
            whole("windowed_grid_sample", f"v1 560^2 C{c}", dt, v1.windowed_grid_sample, x, flow1,
                  v1.windowed_grid_sample.branches, set())
            over = bool((plan2["counts"] > spec.kf).any())
            whole("windowed_warp", f"v2 560^2 C{c}", dt, ops.windowed_warp, x, flow2, ops.windowed_warp.branches,
                  {"tile_recompute"} if over else set())
    torch.cuda.empty_cache()


# Kernel F off its design shapes, (bnt, T, kf, path): the warp path with a
# ragged last block, idle lanes (T 128, 8) and kf past T; the block path at
# two warps with one lane in the second (T 528) and at its largest T; the
# generic path at T not a multiple of 8 or 16 and past the block path's T
COMPACT_EDGES = ((9, 256, 32, "warp"), (7, 128, 16, "warp"), (5, 8, 16, "warp"), (3, 256, 300, "warp"),
                 (3, 528, 8, "block"), (2, 16384, 64, "block"), (392, 4096, 64, "block"),
                 (4, 100, 16, "generic"), (3, 264, 32, "generic"), (2, 4100, 64, "generic"),
                 (2, 16400, 64, "generic"))
COMPACT_KINDS = ("none", "all", "exactly_kf", "past_kf", "random")


def edge_miss(kind, bnt, t, kf, gen, device="cuda"):
    """Flags for one of COMPACT_KINDS: none set, all set, exactly kf set
    (or all of T when kf > T), min(kf, T - kf) set only at positions >= kf,
    or a density of 0.3."""
    import torch

    if kind in ("none", "all"):
        return torch.full((bnt, 1, t), kind == "all", dtype=torch.bool, device=device)
    score = torch.rand(bnt, t, generator=gen, device=device)
    if kind == "random":
        return (score < 0.3)[:, None]
    lo = 0 if kind == "exactly_kf" else min(kf, t)
    score[:, :lo] = 2.0  # never among the smallest
    n = min(kf, t - lo)
    pos = torch.argsort(score, dim=1)[:, :n]
    return torch.zeros(bnt, t, dtype=torch.bool, device=device).scatter_(1, pos, True)[:, None]


def check_compact_edges():
    """Kernel F exactly against its plain version at COMPACT_EDGES in every
    COMPACT_KINDS, each on the path compact_checks must pick; views off the
    vector alignment must take the generic path, and the entry must refuse
    a vector path on such a base."""
    import torch

    from roma_tpu_torch import _ext, ops
    from roma_tpu_torch.ops import window_util as wu

    gen = torch.Generator(device="cuda").manual_seed(11)
    for bnt, t, kf, path in COMPACT_EDGES:
        for kind in COMPACT_KINDS:
            miss = edge_miss(kind, bnt, t, kf, gen)
            require(wu.compact_checks(miss, t, kf) == path, f"compact_miss {bnt}x{t} kf{kf}: not the {path} path")
            ref = ops.compact_miss_reference(miss, t, kf)
            require(torch.equal(ops.compact_miss(miss, t, kf), ref),
                    f"compact_miss {bnt}x{t} kf{kf} {kind} ({path}): kernel disagrees with its plain version")
        print(f"{'compact_miss':26s} {f'edges {bnt} x T{t} kf{kf}':30s} int32    exact on the {path} path "
              f"({', '.join(COMPACT_KINDS)})", flush=True)
    for t, offset, path in ((256, 1, "generic"), (256, 8, "warp"), (4096, 8, "generic"), (4096, 4, "generic")):
        buf = torch.rand(4 * t + 16, generator=gen, device="cuda") < 0.1
        miss = buf[offset:offset + 4 * t].view(4, 1, t)
        require(wu.compact_checks(miss, t, 32) == path, f"compact_miss view {offset} bytes off: not the {path} path")
        require(torch.equal(ops.compact_miss(miss, t, 32), ops.compact_miss_reference(miss, t, 32)),
                f"compact_miss view {offset} bytes off ({path}): kernel disagrees with its plain version")
        if path == "generic":
            out = torch.empty(4, 32, 1, dtype=torch.int32, device="cuda")
            vector = wu.PATH_CODES["warp" if t <= wu.WARP_T_MAX else "block"]
            rc = _ext.lib().roma_compact_miss(miss.data_ptr(), out.data_ptr(), 4, t, 32, vector, _ext.stream())
            require(rc != 0, f"compact_miss: the entry ran a vector path on a base {offset} bytes off")
        print(f"{'compact_miss':26s} {f'view {offset} bytes off, T{t}':30s} int32    exact on the {path} path"
              + (", the vector path refused" if path == "generic" else ""), flush=True)


def run_window_path(results):
    """The windowed samplers and the packed stack as a caller uses them, in
    bf16: windowed_warp at 560^2 and 864^2 (and a wild flow),
    windowed_grid_sample at 864^2, fused_refiner_stack_packed at 560^2 and
    864^2. Counts F, G and H's launches over this run."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.graveyard.window_warp_v1 import windowed_grid_sample

    gen = torch.Generator(device="cuda").manual_seed(4)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    wild = 2.5 * torch.randn(2, 864, 864, 2, generator=gen, device="cuda")
    calls = [(ops.windowed_warp, rn(2, hw, hw, 9), speckled_flow(gen, 2, hw, hw)) for hw in (560, 864)]
    calls += [(ops.windowed_warp, rn(2, 864, 864, 9), wild),
              (windowed_grid_sample, rn(2, 864, 864, 9), gentle_flow(gen, 2, 864, 864))]
    blocks = refiner_blocks(gen)
    calls += [(ops.fused_refiner_stack_packed, rn(2, hw, hw, 24), blocks) for hw in (560, 864)]
    zero_counts()
    outs = [fn(x, arg) for fn, x, arg in calls]
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"windowed samplers and packed stack, bf16: launches {counts}", flush=True)
    for (_, x, _), o in zip(calls, outs):  # every output here has its input's shape
        require(o.shape == x.shape and bool(torch.isfinite(o).all()), "windowed path: bad output")
    for name in WINDOW_KERNELS:
        results[name]["launches"] = counts[name]
    require(all(counts[k] >= 1 for k in WINDOW_KERNELS), f"windowed path launches {counts}")


# the wide-C refiner stacks of the 560 -> 864 match (roma_tpu_torch/tools/
# bench_hcw_refiner.py's SHAPES): (label, H = W, C)
WIDE_SHAPES = (("coarse s16 35^2 C1377", 35, 1377), ("coarse s8 70^2 C1137", 70, 1137),
               ("coarse s4 140^2 C569", 140, 569), ("coarse s2 280^2 C144", 280, 144),
               ("upsample s8 108^2 C1137", 108, 1137), ("upsample s4 216^2 C569", 216, 569),
               ("upsample s2 432^2 C144", 432, 144))


def wide_cost(x, blocks, dt):
    """(bytes, ops, f32_ops, peak) of a folded wide-C stack: each block's
    input and output once plus its weights; the CxC product at the peak of
    its operands (bf16 tensor cores in bf16, CUDA cores in f32) and the
    depthwise on the CUDA cores beside it."""
    import torch

    npx, c = x.numel() // x.shape[-1], x.shape[-1]
    n = len(blocks)
    nbytes = n * (2 * x.numel() * x.element_size() + 4 * (25 * c + c * c + 2 * c))
    return (nbytes, 2 * n * npx * c * c, 2 * 25 * n * npx * c,
            PEAK_BF16_TENSOR if dt == torch.bfloat16 else PEAK_F32)


def check_wide_kernels(results):
    """Kernels I and J against wide_refiner_stack_reference at WIDE_SHAPES
    (B = 2, 9 blocks folded from refiner_block modules), bf16 and f32; in
    bf16 also to I_ULPS and J_ULPS with their planted fault (check_power),
    and timed beside the model's cuDNN block stack on the same modules
    (stack_ms, stack_device_ms of their rows). J runs on the (B, H, C, W)
    copy of the input, made outside the timed window."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.tools.bench_hcw_refiner import make_modules, model_stack

    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, hw, c in WIDE_SHAPES:
        with torch.no_grad():
            mods = make_modules(c, gen, "cuda")
            blocks = ops.fold_refiner(mods[0], mods[1:])
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(2, hw, hw, c, generator=gen, device="cuda").to(dt)
            xt = x.permute(0, 1, 3, 2).contiguous()
            nbytes, nops, dw_ops, peak = wide_cost(x, blocks, dt)

            def chain(fn, y):
                for blk in blocks:
                    y = fn(y, blk)
                return y

            cases = (Case("lane_refiner_block", label, lambda: chain(ops.lane_refiner_block, x),
                          lambda: ops.wide_refiner_stack_reference(x, blocks), bytes=nbytes, ops=nops, peak=peak,
                          f32_ops=dw_ops, stack=(lambda: model_stack(x, mods)) if dt == torch.bfloat16 else None,
                          planted=lambda: refiner_edge_clamped(x, blocks, round_w2=True)),
                     Case("hcw_refiner_block", label, lambda: chain(ops.hcw_refiner_block, xt),
                          lambda: ops.wide_refiner_stack_reference(x, blocks).permute(0, 1, 3, 2),
                          bytes=nbytes, ops=nops, peak=peak, f32_ops=dw_ops,
                          stack=(lambda: model_stack(x, mods).permute(0, 1, 3, 2)) if dt == torch.bfloat16 else None,
                          planted=lambda: refiner_edge_clamped(x, blocks, round_w2=True).permute(0, 1, 3, 2)))
            for case in cases:
                ref = case.plain()
                err = check_output(case.name, label, dt, case.kern(), ref)
                if dt == torch.bfloat16:
                    if case.planted:
                        check_power(case.name, label, "", ref, case.planted(), FAULTS[case.name])
                    with torch.no_grad():
                        record(results[case.name], err, case)
                del ref
            del x, xt
        del mods, blocks
        torch.cuda.empty_cache()


# Kernel J off WIDE_SHAPES, (B, H, W, C): each released width at a small
# size, C = 37 (not a multiple of 8), H < 5 (every staged row partly off the
# image), B = 1, widths that are not a multiple of the block's 32 or 64
# columns, odd and even (the staging by plain loads and by element pairs)
J_EDGES = ((1, 9, 45, 37), (2, 3, 70, 144), (1, 4, 35, 1377), (1, 6, 33, 569), (1, 5, 100, 1137),
           (2, 7, 8, 569))
# Kernel I off WIDE_SHAPES, (B, H, W, C): each released width at a small
# size, odd C (37, and the released 1377, 1137, 569: staged by aligned word
# pairs), an even C not a multiple of 8 (20), C = 16 (one output chunk holds
# every channel: an image row is one run), H < 5, B = 1, widths that are not
# a multiple of the block's 32 or 64 columns
I_EDGES = ((1, 9, 45, 37), (2, 3, 70, 144), (1, 4, 35, 1377), (1, 6, 33, 569), (1, 5, 100, 1137),
           (2, 7, 8, 569), (1, 5, 17, 20), (2, 6, 70, 16))
# Kernel H off its two stacks, (B, H, W, C, K), 5 blocks (groups of 2 and a
# last one of 1 on the c24k5 body): the c24k5 body (bf16 at C = 24, K = 5)
# on ragged tiles (W not a multiple of its 28 columns, W under one tile),
# H < 5 and B = 1; the generic body at odd C, C not a multiple of 8 and
# other K (and every case in f32)
H_EDGES = ((1, 37, 45, 24, 5), (1, 3, 30, 24, 5), (2, 20, 9, 24, 5), (2, 19, 70, 20, 3), (1, 33, 31, 13, 7),
           (1, 8, 9, 5, 1))


def check_wide_edges():
    """Kernel J at J_EDGES and Kernel I at I_EDGES against their plain
    version (3 folded blocks), f32 and bf16 (bf16 to J_ULPS and I_ULPS),
    each bf16 case's path asserted; Kernel H at H_EDGES against its plain
    version and Kernel D (5 folded blocks), each case's body asserted; and
    the bf16 vector paths refusing a misaligned base: J's at a width that is
    a multiple of 4 (8 bytes), I's at C % 8 == 0 (16 bytes) and at an odd C
    (4 bytes), H's c24k5 body (16 bytes)."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops.refiner_stack import packed_checks
    from roma_tpu_torch.ops.wide_refiner import wide_block_checks

    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, h, w, c in I_EDGES:
        blocks = refiner_blocks(gen, c, 3)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dt)
            path = wide_block_checks("check_wide_edges", x, blocks[0], 0)[-1]
            require(path == ("nhwc_tc" if dt == torch.bfloat16 else "tile8x8"), f"I edge C{c} {dt}: path {path}")
            y = x
            for blk in blocks:
                y = ops.lane_refiner_block(y, blk)
            check_output("lane_refiner_block", f"edge {b}x{h}x{w} C{c} x3 {path}", dt, y,
                         ops.wide_refiner_stack_reference(x, blocks))
    for b, h, w, c, k in H_EDGES:
        blocks = refiner_blocks(gen, c, 5, k)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dt)
            path = packed_checks("check_wide_edges", x, blocks)[-2]
            want = "c24k5" if dt == torch.bfloat16 and (c, k) == (24, 5) else "generic"
            require(path == want, f"H edge C{c} K{k} {dt}: body {path}, not {want}")
            got = ops.fused_refiner_stack_packed(x, blocks)
            label = f"edge {b}x{h}x{w} C{c} K{k} x5 {path}"
            check_output("fused_refiner_stack_packed", label, dt, got, ops.refiner_stack_reference(x, blocks))
            check_output("fused_refiner_stack_packed", label, dt, got, ops.fused_refiner_stack(x, blocks),
                         "vs Kernel D ")
    for b, h, w, c in J_EDGES:
        blocks = refiner_blocks(gen, c, 3)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dt)
            y = x.permute(0, 1, 3, 2).contiguous()
            for blk in blocks:
                y = ops.hcw_refiner_block(y, blk)
            check_output("hcw_refiner_block", f"edge {b}x{h}x{w} C{c} x3", dt, y.permute(0, 1, 3, 2),
                         ops.wide_refiner_stack_reference(x, blocks))
    flat = torch.zeros(2 * 8 * 144 * 16 + 8, dtype=torch.bfloat16, device="cuda")
    try:
        ops.hcw_refiner_block(flat[2:2 + 8 * 144 * 16].view(1, 8, 144, 16), refiner_blocks(gen, 144, 1)[0])
    except ValueError as e:
        print(f"misaligned view refused: hcw_refiner_block, x base + 4 bytes: {e}", flush=True)
    else:
        raise SmokeFailure("misaligned view accepted: hcw_refiner_block, x base + 4 bytes")
    flat = torch.zeros(2 * 8 * 16 * 1377 + 16, dtype=torch.bfloat16, device="cuda")
    for what, call in (("lane_refiner_block C144, x base + 8 bytes",
                        lambda: ops.lane_refiner_block(flat[4:4 + 8 * 16 * 144].view(1, 8, 16, 144),
                                                       refiner_blocks(gen, 144, 1)[0])),
                       ("lane_refiner_block C1377, x base + 2 bytes",
                        lambda: ops.lane_refiner_block(flat[1:1 + 8 * 16 * 1377].view(1, 8, 16, 1377),
                                                       refiner_blocks(gen, 1377, 1)[0])),
                       ("fused_refiner_stack_packed C24, x base + 2 bytes",
                        lambda: ops.fused_refiner_stack_packed(flat[1:1 + 8 * 16 * 24].view(1, 8, 16, 24),
                                                               refiner_blocks(gen, 24, 2)))):
        try:
            call()
        except ValueError as e:
            print(f"misaligned view refused: {what}: {e}", flush=True)
        else:
            raise SmokeFailure(f"misaligned view accepted: {what}")


def onehot_library(win, yl, fy):
    """Kernel K's library call: F.grid_sample on a float32 copy of column 0
    as (NT, 1, WH, 1), bilinear, zeros padding, align_corners=True, at
    x = -1 and y = 2 (yl + fy) / (WH - 1) - 1, i.e. at row yl + fy (copy
    and grid made here, outside the timed call). Not bitwise equal to the
    plain version: yl + fy rounds in float32."""
    import torch
    import torch.nn.functional as F

    nt, wh, _ = win.shape
    col = win[:, :, 0].float().reshape(nt, 1, wh, 1)
    gy = 2.0 * (yl.float() + fy) / (wh - 1) - 1.0
    grid = torch.stack((torch.full_like(gy, -1.0), gy), -1)  # (NT, 1, T, 2)
    return lambda: F.grid_sample(col, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True).view(nt, 1, -1)


def window_sum_rms_error(xqc: int, wh: int, ns: int, mean_sq: float) -> float:
    """The expected (rms) rounding error of Kernel L's float32 sum of one
    tile, a random-walk estimate: each float32 addition rounds its result s
    by an independent relative error of rms u / sqrt(3) (u = 2^-24), and a
    partial sum of m zero-mean terms has E[s^2] = m E[x^2], so E[err^2] =
    u^2 / 3 E[x^2] sum_k m_k over the additions. The kernel's additions
    (csrc/onehot_dots.cu): a row's lanes each add their values in order (8 a
    16-byte vector, vectors l, l + 32, ...) and 5 shuffle levels join the 32
    lanes; a tile's lanes each add their row sums in order (rows l, l + 32,
    ...) and 5 levels join them. ``mean_sq`` is E[x^2] of the table."""
    def dealt(n):  # items a lane takes when n are dealt to 32 lanes in turn
        return [n // 32 + (lane < n % 32) for lane in range(32)]

    # lane-sequential partial sums hold m = 2, 3, ... terms (the first
    # addition, 0 + x, is exact); each shuffle level adds all n terms once
    row = sum(m for k in dealt(xqc // 8) for m in range(2, 8 * k + 1)) + 5 * xqc
    rows = wh * ns
    tile = rows * row + xqc * sum(m for k in dealt(rows) for m in range(2, k + 1)) + 5 * rows * xqc
    return 2.0 ** -24 * math.sqrt(tile * mean_sq / 3.0)


def check_onehot_kernels(results):
    """Kernel K's two entries and Kernel L against their plain versions on
    tools/bench_onehot_dots.py's inputs at its sizes: K's f32 entry to the
    f32 bar, its 2bf16 entry bit for bit, beside F.grid_sample computing the
    same function (onehot_library); L to the f32 bar, beside the expected
    rounding error of its two-level sum (window_sum_rms_error) and one
    index_select of the window rows and a float32 sum. A planted fault in
    each plain version (FAULTS) must break the f32 bar. K's bound counts
    one 32-byte sector per window row its taps touch, L's the table rows its
    windows cover, each once (the windows overlap). The memory's own rate on
    each kernel's traffic is printed beside it: one torch.add moving K's
    12 bytes a query, one tab.sum() reading L's whole table."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.tools import bench_onehot_dots as bo

    gen = torch.Generator(device="cuda").manual_seed(6)
    win, yl, fy = bo.e1_inputs(gen)
    nq = yl.numel()
    # one 32-byte sector of column 0 for each (tile, row) this run's taps touch
    touched = torch.zeros(win.shape[0], bo.WH + 1, dtype=torch.bool, device="cuda")
    rows = torch.cat((yl, yl + 1), 1).long()
    rows = torch.where((rows >= 0) & (rows < bo.WH), rows, bo.WH)
    touched.scatter_(1, rows.view(win.shape[0], -1), True)
    sectors = int(touched[:, : bo.WH].sum())
    library = onehot_library(win, yl, fy)
    label = f"E1 NT{win.shape[0]} x {yl.shape[-1]}"
    r = results["onehot_dot"]
    r["entries"] = []
    for form, entry, rep in ONEHOT_ENTRIES:
        case = Case("onehot_dot", f"E1 {form} NT3136 x 4096", lambda f=entry: getattr(ops, f)(win, yl, fy),
                    lambda: ops.onehot_dot_reference(win, yl, fy), bytes=12 * nq + 32 * sectors,
                    ops=3 * nq, library=library)
        check = check_bits if form == "2bf16" else check_output
        err = check(case.name, case.label, torch.float32, case.kern(), case.plain())
        ms, pms = record(r, err, case, "bf16 win")
        r["entries"].append({"entry": entry, "replaces": rep, "ms": ms, "plain_ms": pms, "max_abs_err": err})
    ref = ops.onehot_dot_reference(win, yl, fy)
    check_power("onehot_dot", label, "", ref, onehot_weights_swapped(win, yl, fy), FAULTS["onehot_dot"], f32=True)
    # the memory's own rate on K's traffic: one elementwise op reading 8
    # bytes a query and writing 4 (yl's bits read as floats)
    same = torch.empty_like(fy)
    sms = cuda_ms(lambda: torch.add(yl.view(torch.float32), fy, out=same))
    sdms, _ = device_ms(lambda: torch.add(yl.view(torch.float32), fy, out=same), sms)
    print(f"{'':26s} {label:30s} column-0 sectors touched {sectors} of {win.shape[0] * bo.WH}; "
          f"F.grid_sample max|l-p| {(library() - ref).abs().max().item():.3e} (not bitwise: yl + fy rounds "
          f"in float32); one torch.add on the same bytes {sms:.4f} ms (device {sdms:.4f})", flush=True)
    del win, yl, fy, touched, rows, library, ref, same

    tab, oy, jx, img = bo.e2_inputs(gen)
    nwin = oy.numel() * bo.WH * bo.NS * bo.XQC
    # the windows overlap: the bytes the function must read are the table
    # rows that some window covers, each once
    rows = ops.onehot_dots.window_rows(tab, oy, jx, img, bo.WH, bo.NS).reshape(-1)
    used = torch.zeros(tab.numel() // bo.XQC, dtype=torch.bool, device="cuda")
    used[rows] = True
    nrows = int(used.sum())
    case = Case("window_sum", "E2 NT3024 x 128x3x1152", lambda: ops.window_sum(tab, oy, jx, img, bo.WH, bo.NS),
                lambda: ops.window_sum_reference(tab, oy, jx, img, bo.WH, bo.NS),
                bytes=2 * bo.XQC * nrows + 16 * oy.numel(), ops=bo.XQC * nrows + oy.numel() * bo.WH * bo.NS)
    ref = case.plain()
    err = check_output(case.name, case.label, torch.float32, case.kern(), ref)
    rms = window_sum_rms_error(bo.XQC, bo.WH, bo.NS, tab.float().square().mean().item())
    bar = F32_REL * max(1.0, ref.abs().max().item())
    print(f"{'':26s} {case.label:30s} the two-level f32 sum's expected rounding error {rms:.3e} rms a tile, "
          f"the f32 bar {bar:.3e} ({bar / rms:.0f} x)", flush=True)
    check_power(case.name, case.label, "", ref, window_shifted_down(tab, oy, jx, img, bo.WH, bo.NS),
                FAULTS["window_sum"], f32=True)
    record(results["window_sum"], err, case)
    print(f"{'':26s} {case.label:30s} table rows covered {nrows} of {used.numel()}, window bytes "
          f"{2 * nwin} ({2e3 * nwin / HBM_BYTES_PER_S:.4f} ms at the memory rate)", flush=True)
    tabf = tab.view(-1, bo.XQC)
    ms = cuda_ms(lambda: tabf.index_select(0, rows).view(oy.numel(), -1).sum(1, dtype=torch.float32))
    # the memory's own rate on L's traffic: one reduction reading every
    # table byte once (1.17 x the covered bytes L reads)
    tms = cuda_ms(lambda: tab.sum(dtype=torch.float32))
    tdms, _ = device_ms(lambda: tab.sum(dtype=torch.float32), tms)
    print(f"{'':26s} {case.label:30s} bf16     index_select + sum {ms:.4f} ms; tab.sum() over the whole "
          f"table {tms:.4f} ms (device {tdms:.4f})", flush=True)
    del tab, oy, jx, img, rows, used, tabf, ref
    torch.cuda.empty_cache()


# Kernel K off the tool's sizes, (NT, WH, CWW, T): one tile, WH of 5 and
# 300, T % 4 != 0 (the scalar path) beside T % 4 == 0 (the vector path), T
# over one block's 4096 queries with a partial last chunk, an odd CWW; every
# case's yl holds -1, WH - 1 and rows >= WH besides random rows in
# [-2, WH + 2)
K_EDGES = ((1, 128, 64, 4096), (7, 5, 24, 1000), (5, 300, 40, 333), (3, 128, 1728, 4098), (2, 64, 8, 4100),
           (4, 17, 3, 6))
# Kernel L off the tool's sizes, (B, HP, NJ, XQC, WH, NS, NT): windows that
# leave the table (every third tile of a case with more than one: NaN),
# XQC = 8 (one 16-byte vector a row), NS = 1, one tile, and a row of 513
# vectors (three turns of a lane's 8 loads, the last partial)
L_EDGES = ((2, 150, 8, 1152, 128, 3, 40), (2, 40, 5, 8, 16, 2, 50), (3, 60, 4, 1152, 20, 1, 30),
           (1, 200, 8, 1152, 128, 3, 1), (2, 30, 3, 4104, 8, 2, 64))


def k_edge_inputs(gen, nt, wh, cww, t, device="cuda"):
    """win, yl, fy of a K_EDGES case: yl in [-2, WH + 2), its first four
    queries -1, WH - 1, WH and WH + 5."""
    import torch

    win = torch.randn(nt, wh, cww, generator=gen, device=device).to(torch.bfloat16)
    yl = torch.randint(-2, wh + 2, (nt, 1, t), generator=gen, device=device, dtype=torch.int32)
    yl[:, 0, :4] = torch.tensor([-1, wh - 1, wh, wh + 5], dtype=torch.int32, device=device)[: min(t, 4)]
    fy = torch.rand(nt, 1, t, generator=gen, device=device)
    return win, yl, fy


def l_edge_inputs(gen, b, hp, nj, xqc, wh, ns, nt, device="cuda"):
    """tab, oy, jx, img of an L_EDGES case: windows in the table, but for
    every third tile (of more than one) one that leaves it, by turns past
    the bottom, past the last column, before the first row and in no
    image."""
    import torch

    tab = torch.randn(b, hp, nj, xqc, generator=gen, device=device).to(torch.bfloat16)
    ri = lambda hi: torch.randint(0, hi, (nt,), generator=gen, device=device, dtype=torch.int32)
    oy, jx, img = ri(hp - wh + 1), ri(nj - ns + 1), ri(b)
    if nt > 1:
        for n, i in enumerate(range(1, nt, 3)):
            k = n % 4
            oy[i] = (hp - wh + 1, oy[i], -1, oy[i])[k]
            jx[i] = (jx[i], nj - ns + 1, jx[i], jx[i])[k]
            img[i] = (img[i], img[i], img[i], b)[k]
    return tab, oy, jx, img


def check_window_sums(label, got, ref, off_table):
    """L's output against its plain version: NaN where the plain version
    has NaN, which must be the ``off_table`` tiles whose window leaves the
    table, and the f32 bar elsewhere."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    require(int(nan.sum()) == off_table, f"window_sum {label}: {int(nan.sum())} NaN sums, not {off_table}")
    require(torch.equal(torch.isnan(got), nan), f"window_sum {label}: NaN where the plain version has none, or "
                                                f"the other way")
    check_output("window_sum", f"{label} ({int(nan.sum())} NaN)", torch.float32, got[~nan], ref[~nan])


def check_onehot_edges():
    """Kernel K at K_EDGES (the f32 entry to the f32 bar, the 2bf16 entry
    bit for bit, each case's path asserted) and Kernel L at L_EDGES (NaN
    exactly at the tiles whose window leaves the table, the f32 bar
    elsewhere) against their plain versions; then the misaligned views: L's
    tab 2 bytes off 16 refused (its row sums have no scalar path), K's yl 4
    and fy 8 bytes off at T % 4 == 0 taking the scalar path and held to the
    plain version as above."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.ops.onehot_dots import onehot_checks, window_sum_checks

    gen = torch.Generator(device="cuda").manual_seed(12)
    for nt, wh, cww, t in K_EDGES:
        win, yl, fy = k_edge_inputs(gen, nt, wh, cww, t)
        path = onehot_checks("check_onehot_edges", win, yl, fy, "f32")[4]
        require(path == ("vector" if t % 4 == 0 else "scalar"), f"K edge T{t}: path {path}")
        label = f"edge NT{nt} WH{wh} CWW{cww} T{t} {path}"
        ref = ops.onehot_dot_reference(win, yl, fy)
        check_output("onehot_dot", f"{label} f32", torch.float32, ops.onehot_dot_f32(win, yl, fy), ref)
        check_bits("onehot_dot", f"{label} 2bf16", torch.float32, ops.onehot_dot_2bf16(win, yl, fy), ref)
    for b, hp, nj, xqc, wh, ns, nt in L_EDGES:
        tab, oy, jx, img = l_edge_inputs(gen, b, hp, nj, xqc, wh, ns, nt)
        window_sum_checks("check_onehot_edges", tab, oy, jx, img, wh, ns)
        check_window_sums(f"edge {b}x{hp}x{nj}x{xqc} WH{wh} NS{ns} NT{nt}", ops.window_sum(tab, oy, jx, img, wh, ns),
                          ops.window_sum_reference(tab, oy, jx, img, wh, ns), len(range(1, nt, 3)) if nt > 1 else 0)
    flat = torch.zeros(2 * 40 * 5 * 8 + 8, dtype=torch.bfloat16, device="cuda")
    idx = [torch.zeros(4, dtype=torch.int32, device="cuda") for _ in range(3)]
    try:
        ops.window_sum(flat[1:1 + 2 * 40 * 5 * 8].view(2, 40, 5, 8), *idx, 16, 2)
    except ValueError as e:
        print(f"misaligned view refused: window_sum, tab base + 2 bytes: {e}", flush=True)
    else:
        raise SmokeFailure("misaligned view accepted: window_sum, tab base + 2 bytes")
    nt, wh, cww, t = 2, 128, 64, 4096
    win, yl, fy = k_edge_inputs(gen, nt, wh, cww, t)
    ints = torch.empty(nt * t + 4, dtype=torch.int32, device="cuda")
    floats = torch.empty(nt * t + 4, device="cuda")
    for what, y, f in (("yl base + 4 bytes", ints[1:1 + nt * t].view_as(yl).copy_(yl), fy),
                       ("fy base + 8 bytes", yl, floats[2:2 + nt * t].view_as(fy).copy_(fy))):
        path = onehot_checks("check_onehot_edges", win, y, f, "f32")[4]
        require(path == "scalar", f"K at T{t}, {what}: path {path}, not scalar")
        ref = ops.onehot_dot_reference(win, y, f)
        check_output("onehot_dot", f"{what} scalar f32", torch.float32, ops.onehot_dot_f32(win, y, f), ref)
        check_bits("onehot_dot", f"{what} scalar 2bf16", torch.float32, ops.onehot_dot_2bf16(win, y, f), ref)


def run_graveyard_path(results):
    """The wide-C stack entries and the microbenchmark tools as a caller
    uses them: lane_refiner_stack and hcw_refiner_stack on the upsample
    pass's scale-8 stack (108^2, C 1137, B = 2, bf16), then the port tools'
    e1() and e2() at their defaults. Counts I, J, K and L's launches."""
    import torch

    from roma_tpu_torch import ops
    from roma_tpu_torch.graveyard.pallas_hcw_refiner import hcw_refiner_stack
    from roma_tpu_torch.graveyard.pallas_refiner_lanemajor import lane_refiner_stack
    from roma_tpu_torch.tools import bench_onehot_dots as bo
    from roma_tpu_torch.tools.bench_hcw_refiner import make_modules

    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        mods = make_modules(1137, gen, "cuda")
        blocks = ops.fold_refiner(mods[0], mods[1:])
    x = torch.randn(2, 108, 108, 1137, generator=gen, device="cuda").to(torch.bfloat16)
    zero_counts()
    lane, hcw = lane_refiner_stack(x, blocks), hcw_refiner_stack(x, blocks)
    r1 = bo.e1()
    torch.cuda.empty_cache()
    r2 = bo.e2()
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"wide-C stacks and the microbenchmark tools, as callers: launches {counts}", flush=True)
    for o in (lane, hcw):
        require(o.shape == x.shape and o.dtype == x.dtype and bool(torch.isfinite(o).all()), "wide stack: bad output")
    check_output("hcw_refiner_stack", "vs lane_refiner_stack 108^2", torch.bfloat16, hcw, lane)
    (f32, _), (two, _) = r1["f32"], r1["2bf16"]
    check_output("onehot_dot", "e1 f32 vs 2bf16 entry", torch.float32, f32, two)
    sums, _ = r2["sums"]
    require(tuple(sums.shape) == (bo.NT2, 1) and bool(torch.isfinite(sums).all()), "e2: bad window sums")
    for name in GRAVEYARD_KERNELS:
        results[name]["launches"] = counts[name]
    require(counts["lane_refiner_block"] == counts["hcw_refiner_block"] == len(blocks)
            and all(counts[k] >= 1 for k in GRAVEYARD_KERNELS), f"graveyard path launches {counts}")


# --- Tiny RoMa --------------------------------------------------------------

# A flipped argmax of the approximate pos-embed moves its coarse cell's warp;
# the coarse matcher's four 3x3 layers (4 cells), the bilinear upsampling (1),
# the fine matcher's four 3x3 layers at stride 4 (2) and the output resize
# (1) carry it at most this many coarse cells further.
TINY_FLIP_RADIUS = 8
TINY_ATOL, TINY_RTOL = 5e-4, 1e-3  # the JAX package's bar against its torch spec (tests/test_tiny.py)
# the share of coarse cells whose argmax may flip between two runs of the
# approximate path (near-ties), and the share of output pixels that their
# neighbourhoods may set aside, before a comparison fails
TINY_FLIPS, TINY_ASIDE = 0.01, 0.05


def coarse_best(net, im_A, im_B):
    """(B, hc, wc) argmax over B's coarse cells of each A cell's correlation
    row: the ``best`` of the approximate pos-embed, for /32 float32 inputs,
    with the backbone batched as the net batches it."""
    import torch

    from roma_tpu_torch.models.tiny import corr_volume_qmajor

    with torch.inference_mode():
        if im_A.shape == im_B.shape:
            f_a, f_b = net.xfeat(torch.cat((im_A, im_B)))[1].chunk(2)
        else:
            f_a, f_b = net.xfeat(im_A)[1], net.xfeat(im_B)[1]
        return corr_volume_qmajor(f_a, f_b).argmax(dim=-1).reshape(f_a.shape[:3])


def compare_beside_flips(got, want, flipped, radius: int = TINY_FLIP_RADIUS, atol: float = TINY_ATOL,
                         rtol: float = TINY_RTOL) -> dict:
    """Compare two approximate-path outputs (B, H, W[, C]) whose argmax
    maps may differ at near-ties: the coarse cells ``flipped`` (B, hc, wc)
    and every cell within ``radius`` of one are set aside (resized nearest
    to H, W), the rest is held to ``atol + rtol * |want|``. Returns the
    flipped count, the share of output pixels set aside, the largest excess
    over the bar on the rest (+inf when nothing is left to compare) and the
    largest error there, and ``ok``: at most TINY_FLIPS of the cells
    flipped, at most TINY_ASIDE of the pixels set aside, and no excess."""
    import torch
    import torch.nn.functional as F

    got, want = got.float().cpu(), want.float().cpu()
    if got.ndim == 3:
        got, want = got[..., None], want[..., None]
    aside = F.max_pool2d(flipped.float().cpu()[:, None], 2 * radius + 1, stride=1, padding=radius)
    aside = F.interpolate(aside, size=tuple(got.shape[1:3]), mode="nearest")[:, 0] > 0
    err = (got - want).abs()
    excess = (err - atol - rtol * want.abs()).amax(dim=-1)[~aside]
    out = {"flipped": int(flipped.sum()), "aside": aside.float().mean().item(),
           "excess": excess.max().item() if excess.numel() else math.inf,
           "max_err": err.amax(dim=-1)[~aside].max().item() if excess.numel() else math.inf}
    out["ok"] = out["flipped"] <= TINY_FLIPS * flipped.numel() and out["aside"] <= TINY_ASIDE and out["excess"] <= 0
    return out


TINY_HW, TINY_PROC = (720, 960), (704, 960)  # the request size and its /32 grid
TINY_PARAMS = {"xfeat": 633140, "coarse_matcher": 2069763, "fine_matcher": 139587}  # JAX's init_variables


def conditioned_tiny_weights(seed: int = 0):
    """Reference-format (tiny .pth, XFeat hub) state dicts of seeded weights
    that keep the activations' scale: He-scaled convs, biases 0.1 N(0, 1),
    BN running stats drawn away from (0, 1), from a CPU generator. The zoo's
    own seeded init, N(0, 0.02^2) as the JAX package's, shrinks XFeat's
    coarse features below 1e-6 (tests/test_torch_tiny_zoo.py), so its
    correlation is flat and every argmax a near-tie; comparisons need a
    correlation that selects."""
    import torch

    from roma_tpu_torch.models.tiny import TinyRoMaNet
    from roma_tpu_torch.models.zoo.convert import XFEAT_PREFIX, to_reference

    gen = torch.Generator().manual_seed(seed)
    net = TinyRoMaNet()
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=gen))
            elif name.endswith("running_mean"):
                t.copy_(0.4 * torch.rand(t.shape, generator=gen) - 0.2)
            elif name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("weight"):
                t.copy_(torch.randn(t.shape, generator=gen) * math.sqrt(2.0 / t[0].numel()))
    return to_reference(net, XFEAT_PREFIX)


def tiny_outputs(corresps) -> dict:
    import torch

    return {s: torch.cat((c["flow"], c["certainty"]), dim=-1) for s, c in corresps.items()}


def check_beside_flips(label, got, want, flipped) -> dict:
    """compare_beside_flips with the flip bound: prints and requires."""
    out = compare_beside_flips(got, want, flipped)
    print(f"tiny {label}: flipped argmax {out['flipped']} of {flipped.numel()} cells, set aside "
          f"{out['aside']:.4f} of the pixels, max error on the rest {out['max_err']:.3e} (excess over the bar "
          f"{out['excess']:.3e})", flush=True)
    require(out["ok"], f"tiny {label}: {out['flipped']} argmax flips, {out['aside']:.4f} of the pixels set aside, "
                       f"excess {out['excess']:.3e} beside them")
    return out


def check_tiny_small(weights, device="cuda", hw=(128, 160)):
    """Tiny phase (a): the card against the CPU, float32, TF32 off, the
    same conditioned weights. The net, exact and approximate, on an equal
    and an unequal pair; ``match``; then one training step (XFeat frozen,
    its learning rate 0) with each gradient within 1e-3 of its tensor's
    largest entry and the running statistics within 1e-3 of their own."""
    import numpy as np
    import torch
    import torch.nn as nn

    from roma_tpu_torch import tiny_roma_v1_outdoor
    from roma_tpu_torch.train import TinyRobustLosses, make_optimizer, make_train_step

    rs = np.random.RandomState(5)
    h, w = hw
    pairs = {"equal": (texture(rs, h, w), texture(rs, h, w)), "unequal": (texture(rs, h, w), texture(rs, w, h))}
    for exact in (True, False):
        mode = "exact" if exact else "approximate"
        cpu = tiny_roma_v1_outdoor(*weights, exact_softmax=exact, device="cpu")
        card = tiny_roma_v1_outdoor(*weights, exact_softmax=exact, device=device)
        for label, (a, b) in pairs.items():
            ta, tb = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
            with torch.inference_mode():
                got, want = tiny_outputs(card.net(ta.to(device), tb.to(device))), tiny_outputs(cpu.net(ta, tb))
            flipped = torch.zeros(got[8].shape[:3], dtype=torch.bool)
            if not exact:
                flipped = coarse_best(card.net, ta.to(device), tb.to(device)).cpu() != coarse_best(cpu.net, ta, tb)
            for s in (8, 4):
                check_beside_flips(f"{mode} net {label} {h}x{w} scale {s}, card vs cpu", got[s], want[s], flipped)
        a, b = pairs["equal"]
        (wg, cg), (wc, cc) = card.match(a, b), cpu.match(a, b)
        flipped = torch.zeros(1, h // 8, w // 8, dtype=torch.bool)
        if not exact:
            ta, tb = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
            flipped = coarse_best(card.net, ta.to(device), tb.to(device)).cpu() != coarse_best(cpu.net, ta, tb)
        check_beside_flips(f"{mode} match {h}x{w} warp, card vs cpu", wg[None], wc[None], flipped)
        check_beside_flips(f"{mode} match {h}x{w} certainty, card vs cpu", cg[None], cc[None], flipped)

    steps = {}
    for dev in ("cpu", device):
        net = tiny_roma_v1_outdoor(*weights, device=dev).net.train()
        raw = {}
        for name, p in net.named_parameters():
            p.register_post_accumulate_grad_hook(lambda p, name=name: raw.__setitem__(name, p.grad.clone()))
        opt = make_optimizer(net, encoder_lr=0.0, decoder_lr=2 * 1e-4 / 8, milestones=(100,))
        step = make_train_step(net, TinyRobustLosses(epe_mask_prob_th=0.001), opt)
        m = step(synthetic_train_batch(2, hw, 6, dev, normalize=False))
        stats = {k: v.cpu() for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        steps[dev] = (m["loss"].item(), m["gm_corr_volume_loss_8"].item(), {k: g.cpu() for k, g in raw.items()},
                      stats, [n for n, mod in net.named_modules() if isinstance(mod, nn.BatchNorm2d) and mod.training])
    (lc, cvc, gc, sc, tc), (lg, cvg, gg, sg, tg) = steps["cpu"], steps[device]
    worst = {"loss": abs(lg - lc) / abs(lc),
             "grad (own max)": max((gg[k] - g).abs().max().item() / g.abs().max().item() for k, g in gc.items()),
             "bn stats (own max)": max((sg[k] - v).abs().max().item() / v.abs().max().item() for k, v in sc.items())}
    print(f"tiny train step {h}x{w} f32, card vs cpu: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; loss {lg:.6f} vs {lc:.6f}, corr volume loss {cvg:.6f}", flush=True)
    require(sorted(gg) == sorted(gc) and not any(k.startswith("xfeat.") for k in gc), "tiny: XFeat got gradients")
    require(tc == tg and len(tc) == 8 and not any(k.startswith("xfeat.") for k in tc),
            f"tiny: BatchNorms in train mode {tg}")
    require(cvg > 0 and all(v <= 1e-3 for v in worst.values()), "tiny small train step disagrees")


def tiny_request(model, im_a, im_b, gen):
    """One request: match, 5000 samples, their pixel coordinates."""
    warp, cert = model.match(im_a, im_b)
    matches, _ = model.sample(warp, cert, num=5000, generator=gen)
    kpts = model.to_pixel_coordinates(matches, im_a.height, im_a.width, im_b.height, im_b.width)
    return warp, cert, matches, kpts


def check_tiny_requests(tiny, pairs, profile: bool = False, device="cuda") -> dict:
    """Tiny phase (b): 3 requests on 720 x 960 synthetic pairs (each image
    processed at 704 x 960: coarse 88 x 120), float32 and then bf16; shapes,
    finite values, samples in [-1, 1]; latency, pairs/s after the first
    request and peak memory. Returns pairs/s by dtype."""
    import torch

    out = {}
    h, w = pairs[0][0].height, pairs[0][0].width
    for dtype in (torch.float32, torch.bfloat16):
        tiny.dtype = dtype
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        latencies = []
        for im_a, im_b in pairs:
            t0 = time.perf_counter()
            warp, cert, matches, (kpts_a, kpts_b) = tiny_request(tiny, im_a, im_b, gen)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            require(tuple(warp.shape) == (h, w, 4) and tuple(cert.shape) == (h, w),
                    f"tiny: warp {tuple(warp.shape)}, certainty {tuple(cert.shape)}")
            require(bool(torch.isfinite(warp).all() and torch.isfinite(cert).all()), "tiny: non-finite match")
            require(tuple(matches.shape) == (5000, 4) and matches.abs().max().item() <= 1.0,
                    "tiny: samples must be (5000, 4) in [-1, 1]")
            require(bool(torch.isfinite(kpts_a).all() and torch.isfinite(kpts_b).all()), "tiny: non-finite keypoints")
        name = str(dtype).split(".")[-1]
        out[name] = (len(latencies) - 1) / sum(latencies[1:])
        peak = torch.cuda.max_memory_allocated()
        print(f"tiny request latency s ({name}, {h}x{w} -> {h // 32 * 32}x{w // 32 * 32}): "
              + " ".join(f"{t:.4f}" for t in latencies), flush=True)
        print(f"tiny pairs/s after the first request ({name}): {out[name]:.4f}; peak device memory allocated "
              f"{peak} bytes ({peak / 2**30:.3f} GiB); certainty mean {cert.mean().item():.4f}", flush=True)
        if profile:
            traced(f"tiny request ({name})", lambda: tiny_request(tiny, *pairs[-1], gen))
    tiny.dtype = torch.float32
    return out


def check_tiny_zoo(pair, device="cuda"):
    """Tiny phase (c): the zoo's seeded random weights written as a
    reference-layout tiny .pth and an XFeat state dict, loaded with
    tiny_roma_v1_outdoor(weights=, xfeat_weights=): every tensor equal to
    the file's, the match bit for bit the seeded model's."""
    import torch

    from roma_tpu_torch import tiny_roma_v1_outdoor
    from roma_tpu_torch.models.zoo.convert import XFEAT_PREFIX, to_reference

    seeded = tiny_roma_v1_outdoor(device=device, seed=0)
    with tempfile.TemporaryDirectory() as d:
        paths = os.path.join(d, "tiny_roma_v1_outdoor.pth"), os.path.join(d, "xfeat.pt")
        for sd, path in zip(to_reference(seeded.net, XFEAT_PREFIX), paths):
            torch.save(sd, path)
        t0 = time.perf_counter()
        loaded = tiny_roma_v1_outdoor(*paths, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        files = [torch.load(p, weights_only=True) for p in paths]
    want = {**files[0], **{XFEAT_PREFIX + k: v for k, v in files[1].items()}}
    got = {k: v for k, v in loaded.net.state_dict().items() if not k.endswith("num_batches_tracked")}
    require(sorted(got) == sorted(want) and all(torch.equal(got[k].cpu(), want[k]) for k in want),
            "tiny zoo: a loaded tensor differs from the file's")
    (w0, c0), (w1, c1) = seeded.match(*pair), loaded.match(*pair)
    require(torch.equal(w0, w1) and torch.equal(c0, c1), "tiny zoo: the loaded model's match differs")
    print(f"tiny zoo: {len(want)} tensors loaded from a reference-layout pair in {load_s:.3f} s, all equal to "
          f"the files'; the match equals the seeded model's bit for bit", flush=True)


def check_tiny_serving(tiny, n_pairs: int = 16, batch_size: int = 8, hw=TINY_HW, proc=TINY_PROC, device="cuda"):
    """Tiny phase (d): MatchEngine(tiny, batch_size=8, resize_hw=(704, 960),
    normalize=False) over synthetic PNG pairs, float32: each row against
    tiny.match of its resized [0, 1] arrays beside the argmax flips between
    the engine's batch and one pair; then a second pass, timed (pairs/s)."""
    import numpy as np
    import torch
    from PIL import Image

    from roma_tpu_torch.serving import MatchEngine
    from roma_tpu_torch.utils.image import load_image, resize

    engine = MatchEngine(tiny, batch_size=batch_size, resize_hw=proc, normalize=False)
    with tempfile.TemporaryDirectory() as d:
        pairs = []
        for i in range(n_pairs):
            names = os.path.join(d, f"a{i}.png"), os.path.join(d, f"b{i}.png")
            for im, name in zip(synthetic_pair(100 + i, hw), names):
                im.save(name)
            pairs.append(names)
        results = list(engine.match_paths(pairs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in engine.match_paths(pairs))
        torch.cuda.synchronize()
        pairs_per_s = n / (time.perf_counter() - t0)
        arrays = [[torch.from_numpy(np.array(resize(load_image(p), proc), np.uint8)).to(device).float() / 255.0
                   for p in pair] for pair in pairs]
    require([r.index for r in results] == list(range(n_pairs)), "tiny engine: results out of order")
    worst = {"flipped": 0, "aside": 0.0, "max_err": 0.0}
    for start in range(0, n_pairs, batch_size):
        rows = arrays[start:start + batch_size]
        best_batch = coarse_best(tiny.net, torch.stack([a for a, _ in rows]), torch.stack([b for _, b in rows]))
        for j, (a, b) in enumerate(rows):
            r = results[start + j]
            warp, cert = tiny.match(a, b)
            flipped = (best_batch[j:j + 1] != coarse_best(tiny.net, a[None], b[None])).cpu()
            for label, got, want in (("warp", r.warp, warp), ("certainty", r.certainty, cert)):
                out = compare_beside_flips(got[None], want[None], flipped)
                require(out["ok"], f"tiny engine: pair {r.index} {label} differs from match ({out})")
                worst = {k: max(worst[k], out[k]) for k in worst}
    print(f"tiny engine batch {batch_size}, {n_pairs} pairs at {proc[0]}x{proc[1]}: every row equals tiny.match "
          f"beside the flips (worst pair: flipped {worst['flipped']}, set aside {worst['aside']:.4f}, max error "
          f"{worst['max_err']:.3e}); pairs/s {pairs_per_s:.4f}", flush=True)
    return pairs_per_s


def train_tiny_full(weights, steps: int = 5, batch_size: int = 8, hw=(768, 1024), profile: bool = False,
                    device="cuda"):
    """Tiny phase (e): the recipe's training (experiments/
    train_tiny_roma_v1_outdoor.py: 768 x 1024, batch 8, bf16 autocast, its
    losses, grad clip 0.01) with XFeat frozen at learning rate 0, on
    synthetic identity-pose batches: finite losses, XFeat's parameters and
    running statistics unchanged, the matchers' moved."""
    import torch

    from roma_tpu_torch import tiny_roma_v1_outdoor
    from roma_tpu_torch.train import TinyRobustLosses, make_optimizer, make_train_step

    net = tiny_roma_v1_outdoor(*weights, device=device).net.train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = make_optimizer(net, encoder_lr=0.0, decoder_lr=batch_size * 1e-4 / 8, milestones=(10_000,),
                         grad_clip=0.01)
    loss_fn = TinyRobustLosses(ce_weight=0.01, alpha=0.5, c=1e-4, epe_mask_prob_th=0.001)
    step = make_train_step(net, loss_fn, opt, amp_dtype=torch.bfloat16)
    # two batches in turn: a 768 x 1024 texture takes the host ~0.3 s to draw
    batches = [synthetic_train_batch(batch_size, hw, 20 + i, device, normalize=False) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        batch = batches[i % 2]
        t0 = time.perf_counter()
        m = step(batch)
        loss, cv = m["loss"].item(), m["gm_corr_volume_loss_8"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"tiny train step {i}: loss {loss:.6f} gm_corr_volume_loss_8 {cv:.6f} "
              f"grad_norm {m['grad_norm'].item():.6e} time {times[-1]:.4f} s", flush=True)
        require(math.isfinite(loss) and m["nonfinite_grads"].item() == 0, f"tiny train step {i}: non-finite")
    peak = torch.cuda.max_memory_allocated()
    print(f"tiny train {hw[0]}x{hw[1]} batch {batch_size} bf16 autocast: step time s "
          + " ".join(f"{t:.4f}" for t in times) + f"; samples/s after the first step "
          f"{batch_size * (steps - 1) / sum(times[1:]):.4f}; peak device memory allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    after = net.state_dict()
    xfeat = [k for k in after if k.startswith("xfeat.")]
    require(all(torch.equal(after[k], before[k]) for k in xfeat), "tiny train: XFeat parameters or stats moved")
    stats = [k for k in after if k.endswith("running_mean") and not k.startswith("xfeat.")]
    require(len(stats) == 8 and all(not torch.equal(after[k], before[k]) for k in stats),
            "tiny train: the matchers' BatchNorm statistics did not move")
    if profile:
        traced("tiny train step", lambda: step(batches[-1])["loss"].item())


def check_tiny(profile: bool = False):
    """The Tiny RoMa phase, (a) to (e)."""
    import torch

    from roma_tpu_torch import tiny_roma_v1_outdoor

    t_phase = time.perf_counter()
    weights = conditioned_tiny_weights(0)
    check_tiny_small(weights)
    tiny = tiny_roma_v1_outdoor(*weights, device="cuda")
    counts = {g: sum(p.numel() for p in getattr(tiny.net, g).parameters()) for g in TINY_PARAMS}
    print(f"tiny_roma_v1_outdoor (released architecture, conditioned seeded weights): {sum(counts.values())} "
          f"parameters {counts}", flush=True)
    require(counts == TINY_PARAMS, f"tiny: parameter counts {counts}, not {TINY_PARAMS}")
    pairs = [synthetic_pair(seed, TINY_HW) for seed in range(3)]
    zero_counts()
    rates = check_tiny_requests(tiny, pairs, profile=profile)
    require(not any(read_counts().values()), "tiny: a port kernel launched on the Tiny path")
    check_tiny_zoo(pairs[-1])
    engine_rate = check_tiny_serving(tiny)
    del tiny
    torch.cuda.empty_cache()
    train_tiny_full(weights, profile=profile)
    torch.cuda.empty_cache()
    print(f"tiny phase: pairs/s batch 1 f32 {rates['float32']:.4f}, bf16 {rates['bfloat16']:.4f}, engine batch 8 "
          f"f32 {engine_rate:.4f}; {time.perf_counter() - t_phase:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one more match request and training step with torch.profiler")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    # no weight download, and no weight cache read outside the checkout: the
    # released-architecture models come up on seeded random weights
    os.environ["ROMA_TPU_OFFLINE"] = "1"
    os.environ["ROMA_TPU_CACHE"] = os.path.join(HERE, "build", "no_weight_cache")
    sys.path.insert(0, HERE)
    from roma_tpu_torch import _ext
    from roma_tpu_torch.models.zoo import roma_outdoor

    card = smi_line()
    nvcc = subprocess.run([_ext.nvcc_path(), "--version"], capture_output=True, text=True).stdout
    try:  # reported only: the port's kernels are CUDA C++
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"nvcc {nvcc.strip().splitlines()[-1]}  triton {triton}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _ext.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_ext.library_path().relative_to(HERE)})", flush=True)
    ptxas = _ext.ptxas_log()  # registers and spills per kernel, kept beside the library
    print(ptxas, flush=True)
    check_tc_build(ptxas)

    results = new_results()
    check_kernels(results)
    mega = {k: v for k, v in new_results().items() if k in MEGA_LAUNCHES}  # 672 -> 1344's launches of A-D, N
    check_kernels(mega, MEGA_SHAPES)
    check_match_edges()
    check_attention_kernels(results)
    check_attention_edges()
    check_window_kernels(results)
    check_window_edges()
    check_compact_edges()
    check_wide_kernels(results)
    check_wide_edges()
    check_onehot_kernels(results)
    check_onehot_edges()
    check_resize(results)
    check_small_match()
    check_mega_engine(mega)

    t0 = time.perf_counter()
    model = roma_outdoor(device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.net.parameters())
    print(f"roma_outdoor(560 -> 864, bf16 amp, symmetric): {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    pairs = [synthetic_pair(seed) for seed in range(3)]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    latencies = []

    def request(im_a, im_b):
        warp, cert = model.match(im_a, im_b)
        matches, _ = model.sample(warp, cert, num=5000, generator=gen)
        kpts = model.to_pixel_coordinates(matches, im_a.height, im_a.width, im_b.height, im_b.width)
        return warp, cert, matches, kpts

    zero_counts()
    for im_a, im_b in pairs:
        t0 = time.perf_counter()
        warp, cert, matches, (kpts_a, kpts_b) = request(im_a, im_b)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        require(tuple(warp.shape) == (864, 1728, 4), f"warp shape {tuple(warp.shape)}")
        require(tuple(cert.shape) == (864, 1728), f"certainty shape {tuple(cert.shape)}")
        require(bool(torch.isfinite(warp).all() and torch.isfinite(cert).all()), "non-finite match output")
        require(tuple(matches.shape) == (5000, 4) and matches.abs().max().item() <= 1.0,
                "samples must be (5000, 4) in [-1, 1]")
        require(bool(torch.isfinite(kpts_a).all() and torch.isfinite(kpts_b).all()), "non-finite keypoints")
    launches = read_counts()
    for name in MATCH_KERNELS + ("resize_normalize", WIDE_KERNEL):
        results[name]["launches"] = launches[name]
    print(f"kernel launches during the 3 requests: {launches}")
    require(launches["resize_normalize"] == 2 * len(pairs), "match: M must launch once a canvas a request")
    require(launches[WIDE_KERNEL] == WIDE_LAUNCHES * len(pairs),
            f"match: N must launch {WIDE_LAUNCHES} times a request, once a block of the wide stacks")
    peak = torch.cuda.max_memory_allocated()
    print("request latency s: " + " ".join(f"{t:.4f}" for t in latencies))
    pairs_per_s = (len(latencies) - 1) / sum(latencies[1:])
    print(f"pairs/s after the first request: {pairs_per_s:.4f}")
    print(f"peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)")
    print(f"certainty mean {cert.mean().item():.4f}, warp range [{warp.min().item():.3f}, {warp.max().item():.3f}]")
    missing = [n for n in MATCH_KERNELS if launches[n] == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    if args.profile:
        traced("match request", lambda: request(*pairs[-1]))
    with tempfile.TemporaryDirectory() as d:
        check_int8(model, pairs, {"pairs_per_s": pairs_per_s, "peak": peak}, d)
        torch.cuda.empty_cache()
        paths = check_zoo(model, pairs[-1], warp, cert, d)
        check_release(paths, pairs[0], d)
    torch.cuda.empty_cache()
    check_serving(model, pairs_per_s)
    del model, warp, cert, matches
    torch.cuda.empty_cache()
    check_eval()
    torch.cuda.empty_cache()
    check_tiny(profile=args.profile)

    check_small_train()
    train_full_width(results, profile=args.profile)
    torch.cuda.empty_cache()
    check_recipe(profile=args.profile)
    check_convergence(results)
    check_replicas(results)
    run_sdpa_path(results)
    torch.cuda.empty_cache()
    run_window_path(results)
    torch.cuda.empty_cache()
    run_graveyard_path(results)
    missing = [n for n, r in results.items() if r["launches"] == 0]
    require(not missing, f"kernels never launched: {missing}")
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernel_rows(results)}))
    print(json.dumps({"kernels_672to1344": kernel_rows(mega)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
